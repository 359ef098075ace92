"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  0. environment: torch/CUDA versions, the card's name and power limit, and
     the flash-attention kernel built from csrc/ with nvcc (build seconds);
  1. each kernel entry point vs its plain PyTorch version at the main
     paths' shapes (tolerance 2e-2 in bf16, 1e-4 in f32; TF32 off), with
     both times: B1 (per head, SD1.5 UNet and the SD1.5/SDXL VAE mid-block),
     B2 (head-packed, SDXL base and refiner, also on fused-qkv chunk views)
     and B3 (4-D, the same shapes);
  2. the full-width SD1.5 UNet CFG step (B=2, latent 64², ctx 2x77x768,
     bf16, random weights) through the kernel and with the plain attention
     forced: finite, max|Δ|/max|ref| <= 5e-2;
  3. the txt2img HTTP server with random-weight SD1.5 answering BASELINE
     config 1 requests (512², Euler a, 20 steps, CFG 7.5; batch 1, batch 4
     and a repeated seed): PNGs decoded with the standard library, infotext
     checked, the repeat's image within 2 uint8 levels, and the B1 launch
     count equal to the plan's;
  4. the full-width SDXL base step (B=2, latent 128², ctx 2x77x2048, y
     2x2816) and refiner step (ctx 2x77x1280, y 2x2560), bf16, kernels vs
     plain attention forced (same bound as phase 2), and the SDXL VAE
     decode at 1024² in bf16 and in its fp32 retry dtype;
  5. the server with random SDXL base + refiner answering two BASELINE
     config 5 requests with one seed (1024², DPM++ 2M Karras, 20 steps,
     CFG 7.0, refiner switch at 0.8): 1024x1024 PNGs, infotext naming the
     sampler, seed and refiner, the repeat within 2 uint8 levels, an image
     that is not flat, and B2 and B1 launch counts equal to the plan's;
  6. one more in-process SDXL request under torch.profiler (CUDA activity
     only): wall (median of two untraced requests), device busy (union of
     the kernel intervals), idle share, device time by kernel class and
     the top kernels.
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
Needs a CUDA card; without one it exits 1 and prints no result.
"""

from __future__ import annotations

import base64
import gc
import json
import statistics
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
SDXL_SWITCH_AT = 0.8
VAE_MEAN_DIFF_TOL = 2.0   # uint8 levels, SDXL VAE bf16 vs fp32 decode

# B1 rows: (name, BH, Sq, Skv, D, dtype)
B1_SHAPES = [
    ("unet_64x64_d40", 16, 4096, 4096, 40, torch.bfloat16),
    ("unet_32x32_d80", 16, 1024, 1024, 80, torch.bfloat16),
    ("vae_mid_512", 1, 4096, 4096, 512, torch.bfloat16),
    ("vae_mid_512_f32", 1, 4096, 4096, 512, torch.float32),
    ("vae_mid_1024", 1, 16384, 16384, 512, torch.bfloat16),
    ("vae_mid_1024_f32", 1, 16384, 16384, 512, torch.float32),
    ("ragged_d64", 3, 1000, 1100, 64, torch.bfloat16),
]
# B2 / B3 rows: (name, B, S, H, D), bf16, Sq = Skv = S
HEAD_SHAPES = [
    ("sdxl_base_64x64", 2, 4096, 10, 64),
    ("sdxl_base_32x32", 2, 1024, 20, 64),
    ("sdxl_refiner_64x64", 2, 4096, 12, 64),
    ("sdxl_refiner_32x32", 2, 1024, 24, 64),
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


def _compare(entry, name, shape, dtype, kernel, plain, rows):
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain)
    log(f"{entry} {name} {tuple(shape)} {str(dtype)[6:]}: max|Δ| {err:.3e} (tol {tol:g}), "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if not err <= tol:
        raise AssertionError(f"{entry} disagrees with its plain version at {name}: "
                             f"max|Δ| {err} > {tol}")
    rows.append(dict(entry=entry, name=name, shape=list(shape), dtype=str(dtype)[6:],
                     max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms))


def phase_kernel(device):
    from sdwebui_tpu_torch.ops import flash_attention as fa

    rows = []

    def randn(shape, g, dtype):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    for name, bh, sq, skv, d, dtype in B1_SHAPES:
        g = torch.Generator(device=device).manual_seed(0)
        q, k, v = randn((bh, sq, d), g, dtype), randn((bh, skv, d), g, dtype), \
            randn((bh, skv, d), g, dtype)
        _compare("flash_attention", name, (bh, sq, skv, d), dtype,
                 lambda: fa.flash_attention(q, k, v),
                 lambda: fa.flash_attention_plain(q, k, v), rows)
        del q, k, v
        torch.cuda.empty_cache()
    bf16 = torch.bfloat16
    for name, b, s, h, d in HEAD_SHAPES:
        g = torch.Generator(device=device).manual_seed(1)
        q, k, v = (randn((b, s, h * d), g, bf16) for _ in range(3))
        _compare("flash_attention_packed", name, (b, s, h, d), bf16,
                 lambda: fa.flash_attention_packed(q, k, v, num_heads=h),
                 lambda: fa.flash_attention_packed_plain(q, k, v, num_heads=h), rows)
        q4, k4, v4 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
        _compare("flash_attention_4d", name, (b, s, h, d), bf16,
                 lambda: fa.flash_attention_4d(q4, k4, v4),
                 lambda: fa.flash_attention_4d_plain(q4, k4, v4), rows)
        if name == "sdxl_base_64x64":   # the chunk views of a fused projection
            qkv = randn((b, s, 3 * h * d), g, bf16)
            qc, kc, vc = qkv.chunk(3, dim=-1)
            _compare("flash_attention_packed", name + "_fused_qkv", (b, s, h, d), bf16,
                     lambda: fa.flash_attention_packed(qc, kc, vc, num_heads=h),
                     lambda: fa.flash_attention_packed_plain(qc, kc, vc, num_heads=h), rows)
            del qkv, qc, kc, vc
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    return rows


def _unet_step(label, unet, x, t, ctx, y=None):
    from sdwebui_tpu_torch.ops.attention import forced_impl

    with torch.inference_mode():
        step = lambda: unet(x, t, ctx, y)  # noqa: E731
        out = step().float()
        ms = cuda_ms(step, iters=10)
        with forced_impl("plain"):
            ref = step().float()
            plain_ms = cuda_ms(step, iters=10)
    torch.cuda.synchronize()
    if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"non-finite {label} UNet output")
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    log(f"unet {label}: {tuple(out.shape)}, max|Δ|/max|ref| {rel:.3e} "
        f"(bound {UNET_REL_TOL:g}); {ms:.2f} ms/call with the kernels, "
        f"{plain_ms:.2f} ms/call plain")
    if tuple(out.shape) != tuple(x.shape) or not rel <= UNET_REL_TOL:
        raise AssertionError(f"{label} UNet kernel path disagrees with the plain path: {rel}")
    return dict(rel_err=rel, ms=ms, plain_ms=plain_ms)


def phase_unet(model, device):
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((2, 4, 64, 64), generator=g, device=device).to(torch.bfloat16)
    t = torch.tensor([500.0, 500.0], device=device)
    ctx = torch.randn((2, 77, 768), generator=g, device=device).to(torch.bfloat16)
    return _unet_step("SD1.5 B=2 64x64 bf16", model.unet, x, t, ctx)


def launch_plan(cfg, latent: int):
    """(B2, B1) launches of one UNet forward at latent², from the config and
    the dispatch rule (ops/attention.py)."""
    from sdwebui_tpu_torch.models.unet import self_attention_calls
    from sdwebui_tpu_torch.ops.attention import FLASH_MIN_KV, packs_heads

    long = [(h, d) for s, h, d in self_attention_calls(cfg, latent) if s >= FLASH_MIN_KV]
    packed = sum(packs_heads(d, h) for h, d in long)
    return packed, len(long) - packed


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def _serve(engine, requests, warmup, check, size):
    """POST `requests` to a server around `engine`; returns per request
    (seconds, decoded last image, launches by entry point)."""
    from sdwebui_tpu_torch.ops import flash_attention as fa
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.utils.png import decode_png

    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1/txt2img"
    results = []
    try:
        _post(url, warmup)                        # not timed, not counted
        for body in requests:
            fa.reset_launch_count()
            t0 = time.perf_counter()
            res = _post(url, body)
            dt = time.perf_counter() - t0
            launches = {name: fa.launch_count(name) for name in fa.ENTRY_POINTS}
            info = json.loads(res["info"])
            images = [decode_png(base64.b64decode(b)) for b in res["images"]]
            images = images[info["index_of_first_image"]:]
            if len(images) != body["batch_size"]:
                raise AssertionError(f"{len(images)} images for batch {body['batch_size']}")
            for i, (img, text) in enumerate(images):
                if img.shape != (size, size, 3):
                    raise AssertionError(f"image shape {img.shape}")
                check(text.get("parameters", ""), body["seed"] + i)
            results.append(dict(batch=body["batch_size"], seed=body["seed"], seconds=dt,
                                images_per_s=len(images) / dt, launches=launches,
                                image=images[-1][0]))
            log(f"request {size}² batch {body['batch_size']} seed {body['seed']}: {dt:.3f} s, "
                f"{len(images) / dt:.3f} images/s, launches {launches}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return results


def _check_repeat(results, i, j):
    a, b = results[i]["image"].astype(int), results[j]["image"].astype(int)
    delta = int(abs(a - b).max())
    log(f"repeated seed {results[i]['seed']}: max|Δ| {delta} uint8 levels (bound {REPEAT_TOL})")
    if delta > REPEAT_TOL:
        raise AssertionError(f"repeated seed differs by {delta}")
    if results[i]["image"].std() < 1.0:
        raise AssertionError("the generated image is flat")


def phase_serve(model):
    from sdwebui_tpu_torch.server.app import Engine

    base = dict(prompt="a photograph of an astronaut riding a horse",
                negative_prompt="blurry, lowres", width=512, height=512,
                sampler_name="Euler a", steps=STEPS, cfg_scale=7.5)
    requests = [dict(base, seed=1234, batch_size=1), dict(base, seed=99, batch_size=4),
                dict(base, seed=1234, batch_size=1)]

    def check(params, seed):
        if f"Seed: {seed}" not in params or "Sampler: Euler a" not in params:
            raise AssertionError(f"infotext lacks seed/sampler: {params!r}")

    results = _serve(Engine(model=model, device=model.device), requests,
                     dict(base, seed=1, batch_size=1, steps=2), check, 512)
    _check_repeat(results, 0, 2)
    per_call = launch_plan(model.unet_cfg, 64)[1]
    expected = [dict(flash_attention=STEPS * per_call + 1, flash_attention_packed=0,
                     flash_attention_4d=0)] * len(requests)
    launches = [r["launches"] for r in results]
    log(f"kernel launches per request {launches}, planned {expected}")
    if launches != expected:
        raise AssertionError(f"launch count {launches} != planned {expected}")
    return results


def phase_sdxl_unet(base, refiner, device):
    from sdwebui_tpu_torch.ops import flash_attention as fa
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
        fa.reset_launch_count()
        with torch.inference_mode():
            m.unet(x, t, ctx, y)
        planned = launch_plan(cfg, 128)
        counted = (fa.launch_count("flash_attention_packed"), fa.launch_count())
        log(f"SDXL {label} UNet call: (B2, B1) launches {counted}, planned {planned}")
        if counted != planned:
            raise AssertionError(f"SDXL {label} launches {counted} != planned {planned}")
        out[label] = _unet_step(f"SDXL {label} B=2 128x128 bf16", m.unet, x, t, ctx, y)
        out[label]["launches_per_call"] = planned[0]
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

    results = _serve(engine, [body, body], dict(body, steps=2, seed=1), check, 1024)
    _check_repeat(results, 0, 1)
    sigmas = build_sigmas(get_sampler("DPM++ 2M"), "Karras", STEPS, base.disc, is_sdxl=True)
    s_idx = _refiner_split_idx(base, sigmas, SDXL_SWITCH_AT, STEPS)
    packed = (s_idx * launch_plan(base.unet_cfg, 128)[0]
              + (STEPS - s_idx) * launch_plan(refiner.unet_cfg, 128)[0])
    expected = dict(flash_attention=1, flash_attention_packed=packed, flash_attention_4d=0)
    log(f"refiner takes over after step {s_idx}; planned launches per request {expected}")
    for r in results:
        if r["launches"] != expected:
            raise AssertionError(f"launch count {r['launches']} != planned {expected}")
    return results, s_idx


def kernel_class(name: str) -> str:
    if "flash_attention" in name:
        return "flash_attn"
    if "fprop" in name or "conv" in name.lower():
        return "conv"
    if "gemm" in name.lower() or "nvjet" in name or "cutlass" in name:
        return "gemm"
    if "reduce_kernel" in name:
        return "reduce"
    if "elementwise" in name or "copy" in name.lower():
        return "elementwise"
    return "other"


def phase_profile(engine, refiner):
    """One in-process SDXL request (the server's request parser and
    Engine.txt2img, without HTTP) under torch.profiler (CUDA activity):
    device busy is the union of the kernel intervals; the wall is the
    median of two requests without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from sdwebui_tpu_torch.server.api import _params_from_request

    def run():
        p = _params_from_request(sdxl_request(1234, refiner.title))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.txt2img(p)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

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
    log(f"SDXL request profile: wall {wall:.3f} s (traced {traced:.3f} s), device busy "
        f"{busy_s:.3f} s, idle share {1 - busy_s / wall:.3f}, {len(spans)} device events; "
        "device ms by class " + json.dumps({k: round(v, 1) for k, v in by_class.items()}))
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15
    from sdwebui_tpu_torch.server.app import Engine, random_models

    device = torch.device("cuda")
    phase_env()
    rows = phase_kernel(device)
    t0 = time.perf_counter()
    model = create_random_sd15(seed=0, device=device)
    torch.cuda.synchronize()
    log(f"random SD1.5 on the card in {time.perf_counter() - t0:.2f} s")
    unet = phase_unet(model, device)
    results = phase_serve(model)
    del model
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
    sdxl_results, s_idx = phase_sdxl_serve(engine, base, refiner)
    profile = phase_profile(engine, refiner)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    if leaked:
        raise AssertionError(f"the port imported JAX: {leaked[:5]}")
    requests = [{k: v for k, v in r.items() if k != "image"} for r in results + sdxl_results]
    log(json.dumps({"kernel_shapes": rows, "unet_step": unet, "sdxl_unet_step": sdxl_unet,
                    "sdxl_refiner_after_step": s_idx, "requests": requests,
                    "sdxl_profile": profile}))

    def entry(name, source_line, dominant):
        mine = [r for r in rows if r["entry"] == name]
        row = next(r for r in mine if r["name"] == dominant)
        return {"name": name, "route": "cuda",
                "source": "sdwebui_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"sdwebui_tpu/ops/flash_attention.py:{source_line}",
                "launches": sum(r["launches"][name] for r in requests),
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": row["ms"], "plain_ms": row["plain_ms"]}

    # launches: both paths' timed requests (SD1.5 and SDXL); ms / plain_ms
    # at each entry's dominant shape; max_abs_err over all its compared shapes
    print(json.dumps({"kernels": [
        entry("flash_attention", 111, "unet_64x64_d40"),
        entry("flash_attention_packed", 308, "sdxl_base_64x64"),
        entry("flash_attention_4d", 429, "sdxl_base_64x64"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
