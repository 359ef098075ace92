"""Checkpoint file → ``SDModel`` (the reference's load_model,
modules/sd_models.py:786).

Port of ``sdwebui_tpu/loader/load.py:31-281`` for the families sd1, sd2
(OpenCLIP-H at clip skip 2; the depth variant with its MiDaS tower in
fp32), sdxl and sdxl-refiner, with 9-, 8- and 5-channel UNets; sd3,
AltDiffusion and the SD2 unclip variant raise ``NotImplementedError``
naming them.  Each module is built on ``meta`` (no random init) and takes the
file's tensors with ``load_state_dict(assign=True)``: every tensor is
copied to the device as the file stores it and cast there, so an fp16
file crosses PCIe as fp16 and the host holds no second copy of the file.
Dtypes as in JAX (``load.py:158-197``): the UNet in the policy's
``param_dtype``, the VAE in ``vae_dtype``, the text encoders in fp32.
"""

from __future__ import annotations

import glob
import os

import torch

from sdwebui_tpu_torch.loader import convert, sniff
from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict
from sdwebui_tpu_torch.loader.torch_ckpt import load_torch_checkpoint
from sdwebui_tpu_torch.pipeline.sd_model import SDModel
from sdwebui_tpu_torch.sampling.discretization import Discretization, make_alphas_cumprod
from sdwebui_tpu_torch.text.conditioner import TextConditioner
from sdwebui_tpu_torch.text.tokenizer import get_tokenizer
from sdwebui_tpu_torch.utils.devices import get_device, get_policy
from sdwebui_tpu_torch.utils.options import opts

FAMILIES = ("sd1", "sd2", "sdxl", "sdxl-refiner")

_SD_CACHE: dict = {}


def read_checkpoint(path: str, cache_opt: str = "sd_checkpoint_cache") -> dict:
    """File → state dict, with a host LRU keyed by (path, mtime) of
    opts.sd_checkpoint_cache (sd_vae_checkpoint_cache for VAEs) entries."""
    cache_n = int(opts.get(cache_opt, 0) or 0)
    key = None
    if cache_n > 0:
        try:
            key = (path, os.path.getmtime(path))
        except OSError:
            key = None
        if key is not None and key in _SD_CACHE:
            _SD_CACHE[key] = _SD_CACHE.pop(key)   # LRU touch
            return _SD_CACHE[key]
    sd = read_state_dict(path) if path.endswith(".safetensors") else load_torch_checkpoint(path)
    if key is not None:
        _SD_CACHE[key] = sd
        while len(_SD_CACHE) > cache_n:
            _SD_CACHE.pop(next(iter(_SD_CACHE)))
    return sd


def build(kind: str, cfg, state_dict: dict, device, dtype, **kw) -> torch.nn.Module:
    """The module of `kind` at `cfg` on `device`, its parameters `state_dict`'s
    tensors copied there and cast to `dtype` on the device (4-D weights
    channels-last, as the port's modules hold them); `kw` goes to the
    module's constructor."""
    module = convert.build_module(kind, cfg, device="meta", dtype=dtype, **kw)
    tensors = {}
    for name, t in state_dict.items():
        fmt = torch.channels_last if t.dim() == 4 else torch.contiguous_format
        tensors[name] = t.to(device).to(dtype=dtype, memory_format=fmt)
    module.load_state_dict(tensors, strict=True, assign=True)
    return module


def load_model(path: str, prediction_type: str | None = None, title: str | None = None,
               sha256: str = "", device="cuda") -> SDModel:
    model = model_from_state_dict(read_checkpoint(path), prediction_type=prediction_type,
                                  title=title or os.path.basename(path), sha256=sha256,
                                  device=device)
    model.filename = path
    return model


def model_from_state_dict(sd: dict, prediction_type: str | None = None,
                          title: str = "checkpoint", sha256: str = "",
                          device="cuda") -> SDModel:
    """A whole model from one checkpoint's state dict, hybrid UNets
    (inpainting 9, instruct-pix2pix 8, SD2-depth 5 channels) included; the
    depth variant's MiDaS tower (``depth_model.model.*``) loads in fp32,
    as JAX casts it (load.py:250-281)."""
    info = sniff.sniff(sd)
    if info.family not in FAMILIES:
        raise NotImplementedError(f"checkpoint family {info.family!r} is not ported yet "
                                  f"(ported: {', '.join(FAMILIES)})")
    if info.variant not in ("", "depth"):
        raise NotImplementedError(f"the SD2 {info.variant!r} variant is not ported yet")
    device = torch.device("meta") if str(device) == "meta" else get_device(device)
    policy = get_policy()
    sdxl = info.family.startswith("sdxl")

    unet_sd, unet_cfg = convert.convert_unet(sd)
    unet = build("unet", unet_cfg, unet_sd, device, policy.param_dtype)
    vae_sd, vae_cfg = convert.convert_vae(sd, scale_factor=0.13025 if sdxl else 0.18215)
    vae = build("vae", vae_cfg, vae_sd, device, policy.vae_dtype)

    def conditioner(layout, prefix, **kw):
        convert_fn = convert.convert_clip_hf if layout == "hf" else convert.convert_clip_openclip
        csd, ccfg = convert_fn(sd, prefix)
        clip = build("clip", ccfg, csd, device, torch.float32)
        return TextConditioner(clip, ccfg, get_tokenizer(), **kw)

    cond2 = None
    if info.family == "sd1":
        cond = conditioner("hf", "cond_stage_model.transformer.text_model.")
    elif info.family == "sd2":
        # SD2 conditions on the penultimate layer (open_clip layer="penultimate")
        cond = conditioner("openclip", "cond_stage_model.model.", clip_skip=2)
    elif info.family == "sdxl":
        # sgm: CLIP-L's 'hidden' layer 11 and bigG's penultimate, no final LN
        cond = conditioner("hf", "conditioner.embedders.0.transformer.text_model.",
                           clip_skip=2, apply_final_norm=False)
        cond2 = conditioner("openclip", "conditioner.embedders.1.model.",
                            clip_skip=2, apply_final_norm=False)
    else:
        cond = conditioner("openclip", "conditioner.embedders.0.model.",
                           clip_skip=2, apply_final_norm=False)
    depth_model = None
    if info.variant == "depth":
        dpt_sd, dpt_cfg = convert.convert_dpt(sd)
        depth_model = build("dpt", dpt_cfg, dpt_sd, device, torch.float32)
        if device.type != "meta":
            depth_model.standardize_()
    disc = Discretization(make_alphas_cumprod(),
                          prediction_type=prediction_type or info.prediction_type)
    return SDModel(unet=unet, unet_cfg=unet_cfg, vae=vae, vae_cfg=vae_cfg, disc=disc,
                   conditioner=cond, conditioner2=cond2, device=device,
                   title=f"{title} [{sha256[:10]}]" if sha256 else title,
                   sha256=sha256, kind=info.family, depth_model=depth_model)


def ldm_state_dict(model: SDModel) -> dict:
    """An SD1 or SD2 model's tensors under the ldm checkpoint keys, as the
    model holds them (what load_model reads back): SD2's text encoder in
    open_clip's layout, an SD2-depth model's tower under
    ``depth_model.model.``."""
    if model.kind not in ("sd1", "sd2"):
        raise NotImplementedError(f"writing a {model.kind!r} model's checkpoint is not ported")
    text = model.conditioner.model.state_dict()
    if model.kind == "sd1":
        text = {"cond_stage_model.transformer.text_model." + k: v for k, v in text.items()}
    else:
        text = {"cond_stage_model.model." + k: v
                for k, v in convert.openclip_state_dict(text).items()}
    out = dict(text)
    for prefix, module in (("model.diffusion_model.", model.unet),
                           ("first_stage_model.", model.vae),
                           ("depth_model.model.", model.depth_model)):
        if module is not None:
            out.update({prefix + k: v for k, v in module.state_dict().items()})
    return out


def resolve_vae(checkpoint_path: str, vae_dirs=("models/VAE",)) -> str | None:
    """The reference's VAE selection chain (load.py:69-119): 1) sd_vae
    "None" → the embedded VAE; 2) an explicit sd_vae name is looked up in
    vae_dirs (unless a .vae file beside the checkpoint wins with
    sd_vae_overrides_per_model_preferences off); 3) "Automatic" prefers a
    same-basename .vae.{safetensors,pt,ckpt} beside the checkpoint, then
    vae_dirs."""
    choice = opts.get("sd_vae", "Automatic")
    if choice == "None":
        return None
    exts = (".vae.safetensors", ".vae.pt", ".vae.ckpt", ".safetensors", ".pt", ".ckpt")
    vae_exts = exts[:3]
    base = os.path.splitext(checkpoint_path)[0]

    def near_checkpoint():
        return next((base + e for e in vae_exts if os.path.isfile(base + e)), None)

    if choice not in ("Automatic", None, ""):
        if not opts.get("sd_vae_overrides_per_model_preferences", True):
            near = near_checkpoint()
            if near is not None:
                return near
        for d in vae_dirs:
            for ext in exts:
                cand = os.path.join(d, choice if choice.endswith(ext) else choice + ext)
                if os.path.isfile(cand):
                    return cand
            hit = glob.glob(os.path.join(d, choice))
            if hit:
                return hit[0]
        return None
    near = near_checkpoint()
    if near is not None:
        return near
    name = os.path.basename(base)
    for d in vae_dirs:
        for ext in vae_exts:
            cand = os.path.join(d, name + ext)
            if os.path.isfile(cand):
                return cand
    return None


def load_external_vae(path: str, device, scale_factor: float = 0.18215):
    """A standalone VAE file → (AutoencoderKL at the policy's vae_dtype,
    VAEConfig) (load.py:127-144).  Keys may carry the first_stage_model.
    prefix or be bare."""
    sd = read_checkpoint(path, cache_opt="sd_vae_checkpoint_cache")
    if any(k.startswith("first_stage_model.") for k in sd):
        sd = {k: v for k, v in sd.items() if k.startswith("first_stage_model.")}
    else:
        sd = {"first_stage_model." + k: v for k, v in sd.items()
              if k.startswith(("encoder.", "decoder.", "quant_conv.", "post_quant_conv."))}
    vae_sd, cfg = convert.convert_vae(sd, scale_factor=scale_factor)
    return build("vae", cfg, vae_sd, device, get_policy().vae_dtype), cfg
