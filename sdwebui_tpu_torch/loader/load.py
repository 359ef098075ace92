"""Checkpoint file → ``SDModel`` (the reference's load_model,
modules/sd_models.py:786).

Port of ``sdwebui_tpu/loader/load.py:31-298`` for every family the JAX
loader takes: sd1, sd2 (OpenCLIP-H at clip skip 2; the depth variant with
its MiDaS tower, the unclip variant with its ViT-H image embedder), sdxl
and sdxl-refiner, with 9-, 8- and 5-channel UNets, AltDiffusion (XLM-R)
and SD3 (MMDiT, CLIP-L, bigG and optionally T5-XXL).  Each module is built on ``meta`` (no random init) and takes the
file's tensors with ``load_state_dict(assign=True)``: every tensor is
copied to the device as the file stores it and cast there, so an fp16
file crosses PCIe as fp16 and the host holds no second copy of the file.
Dtypes as in JAX (``load.py:158-197``): the UNet in the policy's
``param_dtype``, the VAE in ``vae_dtype``, the text encoders in fp32
(T5-XXL in ``param_dtype``).  Where SD3's files and the JAX loader part
ways, both are read: bigG in the published files' HF layout
(``text_encoders.clip_g.transformer.``) and in open_clip's, the layout the
JAX loader reads.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import torch

from sdwebui_tpu_torch.loader import convert, sniff
from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict
from sdwebui_tpu_torch.loader.torch_ckpt import load_torch_checkpoint
from sdwebui_tpu_torch.models.clip_vision import convert_openclip_vision
from sdwebui_tpu_torch.models.unet import state_dict_depths
from sdwebui_tpu_torch.models.t5 import convert_t5
from sdwebui_tpu_torch.models.xlmr import AltConditioner, convert_xlmr
from sdwebui_tpu_torch.pipeline.sd_model import SDModel
from sdwebui_tpu_torch.sampling.discretization import (Discretization, FlowDiscretization,
                                                       make_alphas_cumprod)
from sdwebui_tpu_torch.text.conditioner import TextConditioner
from sdwebui_tpu_torch.text.tokenizer import get_tokenizer
from sdwebui_tpu_torch.utils.devices import get_device, get_policy
from sdwebui_tpu_torch.utils.options import opts

FAMILIES = ("sd1", "sd2", "sdxl", "sdxl-refiner", "sd3", "alt")

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
    """A whole model from one checkpoint's state dict (load.py:147-281), of
    every family the JAX loader takes: hybrid UNets (inpainting 9,
    instruct-pix2pix 8, SD2-depth 5 channels; the depth variant's MiDaS
    tower in fp32), the SD2 unclip variant (its open_clip ViT in fp32 and
    the noise augmentor's data statistics), AltDiffusion (XLM-R in fp32,
    the tokenizer from ``models/XLM-R``) and SD3 (the MMDiT, the 16-channel
    VAE at scale 1.5305 and shift 0.0609, the bundled CLIP-L and bigG, and
    T5-XXL, fp8 in the published files, cast to param_dtype, only with
    opts.sd3_enable_t5, its tokenizer from ``models/T5``)."""
    info = sniff.sniff(sd)
    if info.family not in FAMILIES:
        raise NotImplementedError(f"checkpoint family {info.family!r} is not ported yet "
                                  f"(ported: {', '.join(FAMILIES)})")
    device = torch.device("meta") if str(device) == "meta" else get_device(device)
    policy = get_policy()
    sd3 = info.family == "sd3"

    if sd3:
        unet_sd, unet_cfg = convert.convert_mmdit(sd)
        unet = build("mmdit", unet_cfg, unet_sd, device, policy.param_dtype,
                     pre_only_proj=convert.has_pre_only_proj(unet_sd, unet_cfg.depth))
    else:
        unet_sd, unet_cfg = convert.convert_unet(sd)
        # the file's own per-block depths: SSD-1B-style pruned stacks and
        # middle block (convert.verify_tree_names tolerates the groups)
        unet = build("unet", unet_cfg, unet_sd, device, policy.param_dtype,
                     depths=state_dict_depths(unet_sd))
    scale = {"sdxl": 0.13025, "sdxl-refiner": 0.13025, "sd3": 1.5305}.get(info.family, 0.18215)
    vae_sd, vae_cfg = convert.convert_vae(sd, scale_factor=scale)
    if sd3:
        vae_cfg = dataclasses.replace(vae_cfg, shift_factor=0.0609)
    vae = build("vae", vae_cfg, vae_sd, device, policy.vae_dtype, **convert.vae_kwargs(vae_sd))

    def conditioner(layout, prefix, source=sd, **kw):
        if layout == "openclip":
            csd, ccfg = convert.convert_clip_openclip(source, prefix)
        else:     # "hf" (CLIP-L), "hf-gelu" (an HF-layout bigG)
            csd, ccfg = convert.convert_clip_hf(source, prefix,
                                                "gelu" if layout == "hf-gelu" else "quick_gelu")
        clip = build("clip", ccfg, csd, device, torch.float32)
        return TextConditioner(clip, ccfg, get_tokenizer(), **kw)

    cond2 = None
    if info.family in ("sd1", "sd2"):
        if info.family == "sd1":
            cond = conditioner("hf", "cond_stage_model.transformer.text_model.")
        else:    # SD2 conditions on the penultimate layer (open_clip layer="penultimate")
            cond = conditioner("openclip", "cond_stage_model.model.", clip_skip=2)
    elif info.family == "sdxl":
        # sgm: CLIP-L's 'hidden' layer 11 and bigG's penultimate, no final LN
        cond = conditioner("hf", "conditioner.embedders.0.transformer.text_model.",
                           clip_skip=2, apply_final_norm=False)
        cond2 = conditioner("openclip", "conditioner.embedders.1.model.",
                            clip_skip=2, apply_final_norm=False)
    elif info.family == "sdxl-refiner":
        cond = conditioner("openclip", "conditioner.embedders.0.model.",
                           clip_skip=2, apply_final_norm=False)
    elif sd3:
        # the bundled encoders: CLIP-L in HF's layout; bigG in HF's layout
        # (the published files), or open_clip's, which the JAX loader reads
        cond = conditioner("hf", "text_encoders.clip_l.transformer.text_model.",
                           clip_skip=2, apply_final_norm=False)
        if any(k.startswith(SD3_CLIP_G_HF) for k in sd):
            g = {k: v for k, v in sd.items() if k.startswith(SD3_CLIP_G_HF)}
            proj = sd.get("text_encoders.clip_g.transformer.text_projection.weight")
            if proj is not None:     # CLIPTextModelWithProjection's, beside text_model
                g[SD3_CLIP_G_HF + "text_projection.weight"] = proj
            cond2 = conditioner("hf-gelu", SD3_CLIP_G_HF, g, clip_skip=2, apply_final_norm=False)
        else:
            cond2 = conditioner("openclip", "text_encoders.clip_g.model.", clip_skip=2,
                                apply_final_norm=False)
    else:    # alt: XLM-R + its projection (xlmr.py), fp32
        xsd, xcfg, positions = convert_xlmr(sd)
        xlmr = _build_xlmr(xcfg, xsd, positions, device)
        cond = AltConditioner(xlmr, xcfg, find_spm_tokenizer(TOKENIZER_DIRS["xlmr"],
                                                             make="xlmr"))

    t5 = t5_cfg = t5_tok = None
    if sd3 and opts.get("sd3_enable_t5", False) \
            and any(k.startswith("text_encoders.t5xxl.") for k in sd):
        t5_sd, t5_cfg = convert_t5(sd)
        t5 = build("t5", t5_cfg, t5_sd, device, policy.param_dtype)
        t5_tok = find_spm_tokenizer(TOKENIZER_DIRS["t5"], make="t5")

    depth_model = image_embedder = aug_stats = None
    if info.variant == "depth":
        dpt_sd, dpt_cfg = convert.convert_dpt(sd)
        depth_model = build("dpt", dpt_cfg, dpt_sd, device, torch.float32)
        if device.type != "meta":
            depth_model.standardize_()
    elif info.variant == "unclip":
        emb_sd, emb_cfg = convert_openclip_vision(sd)
        image_embedder = build("clip_vision", emb_cfg, emb_sd, device, torch.float32)
        aug_stats = {name: sd[f"noise_augmentor.data_{name}"].to(device, torch.float32)
                     .reshape(-1) for name in ("mean", "std")}
    if sd3:
        disc = FlowDiscretization(shift=3.0)
    else:
        disc = Discretization(make_alphas_cumprod(),
                              prediction_type=prediction_type or info.prediction_type)
    return SDModel(unet=unet, unet_cfg=unet_cfg, vae=vae, vae_cfg=vae_cfg, disc=disc,
                   conditioner=cond, conditioner2=cond2, device=device,
                   title=f"{title} [{sha256[:10]}]" if sha256 else title,
                   sha256=sha256, kind=info.family, depth_model=depth_model,
                   t5=t5, t5_cfg=t5_cfg, t5_tokenizer=t5_tok, image_embedder=image_embedder,
                   noise_aug_stats=aug_stats)


#: the prefix of SD3's bundled bigG in the published files' HF layout
SD3_CLIP_G_HF = "text_encoders.clip_g.transformer.text_model."


def _build_xlmr(cfg, state_dict: dict, positions: int, device):
    from sdwebui_tpu_torch.models.xlmr import XLMRModel

    module = XLMRModel(cfg, device="meta", dtype=torch.float32, positions=positions)
    module.load_state_dict({k: v.to(device).float() for k, v in state_dict.items()},
                           strict=True, assign=True)
    return module


#: where the SentencePiece vocabularies of T5 (SD3) and XLM-R (AltDiffusion)
#: are looked for at load: the reference's ``models/T5`` and ``models/XLM-R``
#: under the working directory, or what :func:`set_tokenizer_dir` says
TOKENIZER_DIRS = {"t5": os.path.join("models", "T5"), "xlmr": os.path.join("models", "XLM-R")}


def set_tokenizer_dir(kind: str, path: str | None) -> None:
    """The directory whose ``*.model`` / ``tokenizer.json`` the loader reads
    for `kind` ("t5" or "xlmr"); None restores the default."""
    default = {"t5": os.path.join("models", "T5"), "xlmr": os.path.join("models", "XLM-R")}
    TOKENIZER_DIRS[kind] = default[kind] if path is None else path


def find_spm_tokenizer(dirpath: str, make: str = "t5"):
    """The SentencePiece tokenizer under `dirpath` (load.py:284-298): the
    first ``*.model``, else a ``tokenizer.json``, through
    ``text/sentencepiece``'s T5 or XLM-R wrapper; None when the directory
    holds neither."""
    hits = sorted(glob.glob(os.path.join(dirpath, "*.model"))) + \
        sorted(glob.glob(os.path.join(dirpath, "tokenizer.json")))
    if not hits:
        return None
    from sdwebui_tpu_torch.text.sentencepiece import make_t5_tokenizer, make_xlmr_tokenizer

    return (make_t5_tokenizer if make == "t5" else make_xlmr_tokenizer)(hits[0])


def ldm_state_dict(model: SDModel) -> dict:
    """A model's tensors under its family's checkpoint keys, as the model
    holds them (what load_model reads back): SD1; SD2 with its text encoder
    in open_clip's layout, an SD2-depth model's tower under
    ``depth_model.model.``, an unclip model's ViT under
    ``embedder.model.visual.`` and its noise statistics; AltDiffusion's
    XLM-R under ``cond_stage_model.``; the SDXL base with CLIP-L under
    ``conditioner.embedders.0.transformer.`` and bigG in open_clip's layout
    under ``conditioner.embedders.1.model.``; SD3 in the published files' layout
    (CLIP-L and bigG under ``text_encoders.clip_{l,g}.transformer.``, T5
    under ``text_encoders.t5xxl.transformer.``)."""
    from sdwebui_tpu_torch.models.clip_vision import openclip_vision_state_dict

    if model.kind not in ("sd1", "sd2", "alt", "sd3", "sdxl"):
        raise NotImplementedError(f"writing a {model.kind!r} model's checkpoint is not ported")

    def under(prefix, module):
        return {prefix + k: v for k, v in module.state_dict().items()}

    text = model.conditioner.model.state_dict()
    if model.kind == "sd1":
        out = under("cond_stage_model.transformer.text_model.", model.conditioner.model)
    elif model.kind == "sd2":
        out = {"cond_stage_model.model." + k: v
               for k, v in convert.openclip_state_dict(text).items()}
    elif model.kind == "alt":
        out = under("cond_stage_model.", model.conditioner.model)
    elif model.kind == "sdxl":
        out = under("conditioner.embedders.0.transformer.text_model.", model.conditioner.model)
        out.update({"conditioner.embedders.1.model." + k: v for k, v in convert.openclip_state_dict(
            model.conditioner2.model.state_dict()).items()})
    else:
        out = under("text_encoders.clip_l.transformer.text_model.", model.conditioner.model)
        g = dict(model.conditioner2.model.state_dict())
        proj = g.pop("text_projection.weight", None)
        out.update({SD3_CLIP_G_HF + k: v for k, v in g.items()})
        if proj is not None:
            out["text_encoders.clip_g.transformer.text_projection.weight"] = proj
        if model.t5 is not None:
            out.update(under("text_encoders.t5xxl.transformer.", model.t5))
    for prefix, module in (("model.diffusion_model.", model.unet),
                           ("first_stage_model.", model.vae),
                           ("depth_model.model.", model.depth_model)):
        if module is not None:
            out.update(under(prefix, module))
    if model.image_embedder is not None:
        out.update(openclip_vision_state_dict(model.image_embedder))
        out.update({f"noise_augmentor.data_{k}": v.reshape(1, -1)
                    for k, v in model.noise_aug_stats.items()})
    return out


#: the transformer depths SSD-1B keeps where it prunes an SDXL UNet; its
#: middle block keeps only the first ResBlock (the reference's
#: convert_sdxl_to_ssd, modules/sd_hijack.py:191)
SSD1B_DEPTHS = {"input_blocks.7.1": 4, "input_blocks.8.1": 4, "output_blocks.0.1": 4,
                "output_blocks.1.1": 4, "output_blocks.4.1": 1, "output_blocks.5.1": 1}


def pruned_state_dict(sd: dict, depths: dict) -> dict:
    """A checkpoint `sd` less the transformer blocks past `depths[block]` of
    each block and less middle_block.1 and .2: SSD-1B's kind of pruning
    (``ssd1b_state_dict``)."""
    prefix = "model.diffusion_model."
    drop = [f"{prefix}middle_block.1.", f"{prefix}middle_block.2."]

    def kept(name):
        if any(name.startswith(d) for d in drop):
            return False
        for block, depth in depths.items():
            head = f"{prefix}{block}.transformer_blocks."
            if name.startswith(head) and int(name[len(head):].split(".", 1)[0]) >= depth:
                return False
        return True

    return {k: v for k, v in sd.items() if kept(k)}


def ssd1b_state_dict(model: SDModel) -> dict:
    """An SDXL base's checkpoint with SSD-1B's pruning (``SSD1B_DEPTHS``
    and no middle attention): the pruned SDXL file at published widths."""
    return pruned_state_dict(ldm_state_dict(model), SSD1B_DEPTHS)


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
    return build("vae", cfg, vae_sd, device, get_policy().vae_dtype,
                 **convert.vae_kwargs(vae_sd)), cfg
