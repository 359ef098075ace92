"""LDSR, latent-diffusion 4x super-resolution — port of
``sdwebui_tpu/models/ldsr.py``.

The pipeline (``super_resolution``): pad the LR image to a multiple of 64
(edge mode), draw the DDIM noise on the host, run DDIM in alpha space at
eta 1 over the UNet with the raw LR image concatenated to the latent each
step, VQ-quantize and decode to the 4x image, crop, then a Pillow-exact
LANCZOS to the requested scale (``utils/images.resize``).

The nets (from the checkpoint's shapes): the context-free LDM UNet with
legacy AttentionBlocks (``models/unet``, ``legacy_attention=True``; in
bf16, as JAX casts its input at ``ldsr.py:103``) and the f4 VQGAN
(``models/vae.VQModel``, f32).  On CUDA the UNet's attention at ds 8 runs
B2 (640 channels as 20 heads of 32 over (LR/8)² tokens) and the VQ
decoder's mid-block B1 (f32, d = 512, S = the LR image's pixels).

Kept from JAX: the subsequence (ldm ``make_ddim_timesteps``, the +1 clipped
to T − 1), the step below the last subsequence timestep is t = 0 (a_prev =
alphas_cumprod[0]), the UNet input ``[x_t ⊕ LR]`` cast to bf16 and its
output read back in f32, and the noise: ``np.random.default_rng(seed)``'s
standard normals drawn in JAX's NHWC order, x_T first, then every step's
(``ldsr.py:185-189``), so both packages draw the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdwebui_tpu_torch.loader.convert import derive_unet_config, derive_vae_config
from sdwebui_tpu_torch.models.configs import UNetConfig, VAEConfig
from sdwebui_tpu_torch.models.layers import reset_random
from sdwebui_tpu_torch.models.unet import AttentionBlock, UNetModel
from sdwebui_tpu_torch.models.vae import VQModel
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.devices import get_device
from sdwebui_tpu_torch.utils.options import opts


@dataclasses.dataclass(frozen=True)
class LDSRConfig:
    unet: UNetConfig = None
    vq: VAEConfig = None
    n_embed: int = 8192
    timesteps: int = 1000
    linear_start: float = 0.0015
    linear_end: float = 0.0155


#: CompVis latent-diffusion's bsr_sr model (LDSR's project.yaml): UNet
#: model_channels 160, channel_mult (1, 2, 2, 4), 2 res blocks, attention at
#: ds 8 in 32-channel heads, 6 → 3 channels; the f4 VQGAN: embed_dim 3,
#: n_embed 8192, ch 128, ch_mult (1, 2, 4), double_z false
LDSR_UNET = UNetConfig(in_channels=6, out_channels=3, model_channels=160,
                       channel_mult=(1, 2, 2, 4), attention_resolutions=(8,),
                       transformer_depth=(0, 0, 0, 1), num_heads=-1, num_head_channels=32)
LDSR_VQ = VAEConfig(embed_dim=3, z_channels=3, ch=128, ch_mult=(1, 2, 4),
                    scale_factor=1.0, shift_factor=0.0)
BSR_SR = LDSRConfig(unet=LDSR_UNET, vq=LDSR_VQ)


class LDSR(torch.nn.Module):
    def __init__(self, cfg: LDSRConfig, device="cpu", unet_dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.unet = UNetModel(cfg.unet, device=device, dtype=unet_dtype, legacy_attention=True)
        self.vq = VQModel(cfg.vq, cfg.n_embed, device=device, dtype=torch.float32)

    @property
    def device(self) -> torch.device:
        return self.vq.quantize.embedding.weight.device


# --------------------------------------------------------------------------
# DDIM in alpha space (the reference's DDIMSampler, eta 1)
# --------------------------------------------------------------------------

def make_alphas(cfg: LDSRConfig) -> np.ndarray:
    """alphas_cumprod of the linear-in-sqrt beta schedule (ldsr.py:73-76)."""
    betas = np.linspace(cfg.linear_start ** 0.5, cfg.linear_end ** 0.5,
                        cfg.timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_timesteps(cfg: LDSRConfig, steps: int) -> np.ndarray:
    """The DDIM subsequence, high to low: ldm's uniform ``make_ddim_timesteps``
    with its +1, clipped to T − 1 (ldsr.py:192-198)."""
    c = cfg.timesteps // steps
    return np.clip(np.asarray(range(0, cfg.timesteps, c)) + 1, 0,
                   cfg.timesteps - 1)[::-1].copy()


def ddim_sample(eps_fn, lr_cond, noise_seq, x_t, alphas_cumprod, timesteps_seq,
                eta: float = 1.0):
    """x_T → x_0 over the subsequence (ldsr.py:81-117): each step
    eps = eps_fn([x_t ⊕ LR], t), then x_prev = √a_prev·x̂0 + dir + σ·z.
    NCHW tensors: lr_cond (B, 3, H, W), noise_seq (steps, B, C, H, W);
    alphas_cumprod a float32 tensor on their device; timesteps_seq ints."""
    n_ts = len(timesteps_seq)
    for i in range(noise_seq.shape[0]):
        t = int(timesteps_seq[i])
        t_prev = int(timesteps_seq[i + 1]) if i + 1 < n_ts else 0
        a_t, a_prev = alphas_cumprod[t], alphas_cumprod[t_prev]
        x_in = torch.cat([x_t, lr_cond], dim=1)
        tb = torch.full((x_t.shape[0],), float(t), dtype=torch.float32, device=x_t.device)
        eps = eps_fn(x_in, tb)
        x0 = (x_t - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)) * eps
        x_t = torch.sqrt(a_prev) * x0 + dir_xt + sigma * noise_seq[i]
    return x_t


def unet_eps_fn(unet: UNetModel):
    """The UNet as DDIM's eps function: input cast to the UNet's dtype
    (bf16), eps read back in f32."""
    dtype = next(unet.parameters()).dtype

    def eps_fn(x_in, tb):
        return unet(x_in.to(dtype), tb, None).float()
    return eps_fn


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------

def draw_noise(seed: int, hh: int, ww: int, channels: int, steps: int):
    """(x_T, noise_seq) as numpy NHWC: default_rng(seed)'s draws in JAX's
    order and shapes (ldsr.py:185-189)."""
    rng = np.random.default_rng(seed)
    x_t = rng.standard_normal((1, hh, ww, channels)).astype(np.float32)
    noise = rng.standard_normal((steps, 1, hh, ww, channels)).astype(np.float32)
    return x_t, noise


@torch.inference_mode()
def super_resolution(model: LDSR, image: np.ndarray, steps: int = 100,
                     target_scale: float = 4.0, eta: float = 1.0, seed: int = 0,
                     return_latent: bool = False):
    """RGB uint8 (H, W, 3) → the 4x diffusion result resized to
    target_scale (ldsr.py:170-208); with return_latent also the final
    latent (NCHW f32) before quantization."""
    cfg, device = model.cfg, model.device
    img = images_util.to_rgb(image)
    h0, w0 = img.shape[:2]
    ph, pw = (-h0) % 64, (-w0) % 64
    arr = img.astype(np.float32) / 255.0
    if pw or ph:
        arr = np.pad(arr, ((0, ph), (0, pw), (0, 0)), "edge")
    lr = torch.from_numpy(arr[None] * 2.0 - 1.0).to(device).permute(0, 3, 1, 2)
    hh, ww = arr.shape[:2]
    x_t, noise = draw_noise(seed, hh, ww, cfg.vq.embed_dim, steps)
    x_t = torch.from_numpy(x_t).to(device).permute(0, 3, 1, 2)
    noise = torch.from_numpy(noise).to(device).permute(0, 1, 4, 2, 3)
    alphas = torch.as_tensor(make_alphas(cfg), dtype=torch.float32, device=device)
    z = ddim_sample(unet_eps_fn(model.unet), lr, noise, x_t, alphas,
                    ddim_timesteps(cfg, steps), eta)
    out = model.vq.vq_decode(z.float())
    out = torch.clamp(out / 2.0 + 0.5, 0.0, 1.0)[0].permute(1, 2, 0).cpu().numpy()
    out = (out[: h0 * 4, : w0 * 4] * 255 + 0.5).astype(np.uint8)
    if target_scale != 4.0:
        out = images_util.resize(out, (round(w0 * target_scale), round(h0 * target_scale)),
                                 "lanczos")
    return (out, z) if return_latent else out


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

def derive_ldsr_config(sd: dict) -> LDSRConfig:
    """The UNet's config (legacy heads of 32 channels) and the VQ's from the
    checkpoint's shapes (ldsr.py:122-167)."""
    ucfg = derive_unet_config(sd, "model.diffusion_model.")
    vcfg = derive_vae_config(sd, "first_stage_model.", scale_factor=1.0)
    vcfg = dataclasses.replace(vcfg, z_channels=vcfg.embed_dim)
    return LDSRConfig(unet=ucfg, vq=vcfg,
                      n_embed=int(sd["first_stage_model.quantize.embedding.weight"].shape[0]))


def ldsr_from_state_dict(sd: dict, device="cuda") -> LDSR:
    """An LDSR checkpoint's state dict (``model.diffusion_model.*`` and
    ``first_stage_model.*``; the rest ignored) → the model on `device`:
    the UNet cast to bf16, the VQ in f32."""
    device = get_device(device)
    cfg = derive_ldsr_config(sd)
    model = LDSR(cfg, device="meta")
    own = model.state_dict()
    parts = {"unet.": "model.diffusion_model.", "vq.": "first_stage_model."}
    picked = {}
    for k, slot in own.items():
        prefix = next(p for p in parts if k.startswith(p))
        src = parts[prefix] + k[len(prefix):]
        if src not in sd:
            raise ValueError(f"LDSR checkpoint lacks {src}")
        v = torch.as_tensor(sd[src])
        if tuple(v.shape) != tuple(slot.shape):
            raise ValueError(f"{src}: shape {tuple(v.shape)}, expected {tuple(slot.shape)}")
        v = v.to(device=device, dtype=slot.dtype, copy=True)
        # conv weights channels-last, as the port's modules hold them (the
        # activations are): no layout conversion around each convolution
        picked[k] = v.contiguous(memory_format=torch.channels_last) if v.dim() == 4 else v
    model.load_state_dict(picked, assign=True)
    return model.eval()


def ldsr_state_dict(model: LDSR) -> dict:
    """The model's tensors under the checkpoint's keys."""
    names = {"unet.": "model.diffusion_model.", "vq.": "first_stage_model."}
    return {names[k[:k.index(".") + 1]] + k[k.index(".") + 1:]: v
            for k, v in model.state_dict().items()}


def ldsr_from_jax(unet_tree: dict, vq_tree: dict, device="cpu") -> LDSR:
    """The JAX package's trees (``load_ldsr``'s: the UNet's ``convert_unet``
    layout with the legacy (3C, C, 1) qkv kept, the VQ's with its codebook
    kept (n_embed, dim)) → the model."""
    from sdwebui_tpu_torch.models.swinir import state_dict_from_jax

    sd = {"model.diffusion_model." + k: v for k, v in state_dict_from_jax(unet_tree).items()}
    sd.update({"first_stage_model." + k: v for k, v in state_dict_from_jax(
        vq_tree, keep=("quantize.embedding.weight",)).items()})
    return ldsr_from_state_dict(sd, device)


def create_random_ldsr(seed: int = 0, device="cuda", cfg: LDSRConfig = BSR_SR) -> LDSR:
    """A seeded random LDSR at `cfg` (default the bsr_sr model's published
    widths): the layers' own init, the legacy blocks' projections
    N(0, 1/C), the codebook N(0, 1)."""
    device = get_device(device)
    model = LDSR(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    reset_random(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, AttentionBlock):
                m.reset_random(gen)
        cb = model.vq.quantize.embedding.weight
        cb.copy_(torch.randn(cb.shape, generator=gen, device=device))
    return model.eval()


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

def register_ldsr_dir(dirs=("models/LDSR",), device="cuda") -> list:
    """Register every .ckpt / .safetensors / .pt file of `dirs`: "LDSR"
    for ``model*`` / ``last*`` files, else "LDSR (<name>)"; each request
    runs opts.ldsr_steps steps on `device` (ldsr.py:211-243)."""
    import os

    from sdwebui_tpu_torch.models.swinir import model_files, register_lazy

    def load(path):
        from sdwebui_tpu_torch.loader.load import read_checkpoint

        return ldsr_from_state_dict(read_checkpoint(path), device)

    device = get_device(device)
    found = []
    for stem, path in model_files(dirs, exts=(".ckpt", ".safetensors", ".pt")):
        fn = os.path.basename(path)
        name = "LDSR" if fn.startswith(("model", "last")) else f"LDSR ({stem})"
        register_lazy(name, path, load, lambda model, image, scale: super_resolution(
            model, image, steps=int(opts.get("ldsr_steps", 100)), target_scale=float(scale)))
        found.append(name)
    return found
