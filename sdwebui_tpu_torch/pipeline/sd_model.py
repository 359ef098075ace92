"""The loaded-model bundle: UNet + VAE + text encoder(s) + discretization.

Port of ``sdwebui_tpu/pipeline/sd_model.py:29-113,223-258,319-411,445-464``
for SD1.x, SD2.x (and SD2-depth's MiDaS tower) and the SDXL base and
refiner (a checkpoint file's
bundle comes from ``loader/load.py``).  The bundle holds ``nn.Module``s
on one explicit device.  Random weights come
from an explicit ``torch.Generator`` on that device, with the
distributions of the JAX package's ``HostInit`` (normal·1/√fan_in, zero
bias, unit norms); the bits differ from JAX's.  ``from_jax`` carries a JAX
model's weights across, so both packages can run on identical parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdwebui_tpu_torch.models.clip import CLIPTextModel
from sdwebui_tpu_torch.models.configs import (CLIP_L, OPEN_CLIP_BIGG, OPEN_CLIP_H,
                                              SD15_UNET, SD21_UNET, SD_VAE,
                                              SDXL_REFINER_UNET, SDXL_UNET, SDXL_VAE,
                                              CLIPTextConfig, UNetConfig, VAEConfig)
from sdwebui_tpu_torch.models.layers import reset_random, timestep_embedding
from sdwebui_tpu_torch.models.midas import DPTConfig, DPTDepthModel, create_random_dpt
from sdwebui_tpu_torch.models.unet import UNetModel
from sdwebui_tpu_torch.models.vae import AutoencoderKL
from sdwebui_tpu_torch.sampling.discretization import (Discretization,
                                                       make_alphas_cumprod)
from sdwebui_tpu_torch.text.conditioner import TextConditioner
from sdwebui_tpu_torch.text.tokenizer import get_tokenizer
from sdwebui_tpu_torch.utils.devices import get_device, get_policy
from sdwebui_tpu_torch.utils.pytree import flatten

# 2-D leaves stored (rows, width) in both layouts (loader/convert.py:25).
# text_projection is not among them: the JAX tree holds it (in, out), the
# port as HF's bias-free Linear, (out, in).
_NO_TRANSPOSE_2D = ("token_embedding", "position_embedding", "positional_embedding")


@dataclasses.dataclass
class SDModel:
    unet: UNetModel
    unet_cfg: UNetConfig
    vae: AutoencoderKL
    vae_cfg: VAEConfig
    disc: Discretization
    conditioner: TextConditioner          # primary text encoder
    device: torch.device
    title: str = "random-sd15"            # "<file name> [<sha256[:10]>]" when loaded
    sha256: str = ""
    kind: str = "sd1"                     # sd1 | sd2 | sdxl | sdxl-refiner
    conditioner2: TextConditioner | None = None   # SDXL base's OpenCLIP-bigG
    filename: str = ""                    # the checkpoint file, when loaded from one
    vae_file: str = ""                    # an external VAE file in use, else ""
    vae_sha256: str = ""
    embedded_vae: AutoencoderKL | None = None   # the checkpoint's own VAE meanwhile
    # merged LoRA modules by tag set (networks/extra_networks.apply_to_model);
    # they share the base's other parameters, so they go when the model moves
    network_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    # SD2-depth's MiDaS tower (fp32), the 5-channel UNet's conditioner
    depth_model: DPTDepthModel | None = None

    @property
    def is_sdxl(self) -> bool:
        return self.kind.startswith("sdxl")

    @property
    def is_depth(self) -> bool:
        """hybrid depth conditioning (SD2-depth, 5-channel UNet)."""
        return self.depth_model is not None

    @property
    def latent_channels(self) -> int:
        return self.vae_cfg.embed_dim

    def to(self, device) -> "SDModel":
        """Move every module to `device` (in place; parks a displaced
        checkpoint in host RAM with "cpu").  Merged LoRA copies are dropped,
        never moved."""
        self.network_cache.clear()
        self.device = torch.device(device)
        for cond in (self.conditioner, self.conditioner2):
            if cond is not None:
                cond.model.to(self.device)
        for module in (self.unet, self.vae, self.embedded_vae, self.depth_model):
            if module is not None:
                module.to(self.device)
        return self

    def encode_texts(self, texts, target_chunks=None):
        """texts → (N, S, D) crossattn conds, or (conds, pooled) for SDXL:
        the base concatenates CLIP-L and bigG on features and pools bigG;
        the refiner has bigG alone (sd_model.py:80-113)."""
        cond, pooled = self.conditioner.encode(texts, target_chunks=target_chunks)
        if self.kind == "sdxl":
            cond2, pooled = self.conditioner2.encode(texts, target_chunks=target_chunks)
            return torch.cat([cond, cond2], dim=-1), pooled
        if self.kind == "sdxl-refiner":
            return cond, pooled
        return cond


def sdxl_vector_maker(model: SDModel, width: int, height: int, crop: tuple = (0, 0),
                      aesthetic_score: float = 6.0,
                      negative_aesthetic_score: float = 2.5):
    """SDXL adm vector builder (sd_model.py:223-258):

    base:    [pooled | emb(orig_h, orig_w) | emb(crop_t, crop_l) | emb(target_h, target_w)]
    refiner: [pooled | emb(orig_h, orig_w) | emb(crop_t, crop_l) | emb(aesthetic score)]

    each scalar sinusoid-embedded at dim 256 (the sgm layout), all fp32.
    Returns maker(pooled (N, Dp), is_uncond (N,) bool) -> (N, D_adm)."""
    refiner = model.kind == "sdxl-refiner"

    def emb_scalars(values, device):
        t = torch.tensor([float(v) for v in values], dtype=torch.float32, device=device)
        return timestep_embedding(t, 256).reshape(-1)

    sizes = [height, width, crop[0], crop[1]] + ([] if refiner else [height, width])

    def maker(pooled, is_uncond):
        n = pooled.shape[0]
        tail = emb_scalars(sizes, pooled.device)[None].expand(n, -1)
        if refiner:
            pos, neg = emb_scalars([aesthetic_score], pooled.device), \
                emb_scalars([negative_aesthetic_score], pooled.device)
            tail = torch.cat([tail, torch.where(is_uncond[:, None], neg[None], pos[None])],
                             dim=-1)
        return torch.cat([pooled.float(), tail], dim=-1)

    return maker


def _bundle(unet, vae, clip, clip_cfg, device, title, disc) -> SDModel:
    return SDModel(
        unet=unet, unet_cfg=unet.cfg, vae=vae, vae_cfg=vae.cfg, disc=disc,
        conditioner=TextConditioner(clip, clip_cfg, get_tokenizer()),
        device=device, title=title)


def _random(module, seed: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    reset_random(module, gen)
    return module


def create_random_sd15(seed: int = 0, device="cuda", dtype: torch.dtype | None = None,
                       prediction_type: str = "eps", in_channels: int = 4) -> SDModel:
    """Random-weight SD1.5 at full width: the same compute graph as a real
    checkpoint (in_channels 9: sd-v1-5-inpainting's, 8: instruct-pix2pix's).
    UNet in `dtype` (default: the policy's param_dtype); VAE and CLIP in
    fp32, as in JAX."""
    device = get_device(device)
    dtype = dtype or get_policy().param_dtype
    unet_cfg = dataclasses.replace(SD15_UNET, in_channels=in_channels)
    unet = _random(UNetModel(unet_cfg, device=device, dtype=dtype), seed, device)
    clip = _random(CLIPTextModel(CLIP_L, device=device, dtype=torch.float32),
                   seed + 1, device)
    vae = _random(AutoencoderKL(SD_VAE, device=device, dtype=torch.float32),
                  seed + 2, device)
    return _bundle(unet, vae, clip, CLIP_L, device, "random-sd15.safetensors [0000000000]",
                   Discretization(make_alphas_cumprod(), prediction_type=prediction_type))


def create_random_sd2_depth(seed: int = 0, device="cuda") -> SDModel:
    """Random-weight SD2-depth at full width (Stability's 512-depth-ema:
    the SD2 UNet with 5 input channels, OpenCLIP-H at clip skip 2, the SD
    VAE, the MiDaS DPT-hybrid at the published widths).  UNet in the
    policy's param_dtype; the rest in fp32."""
    device = get_device(device)
    unet_cfg = dataclasses.replace(SD21_UNET, in_channels=5)
    unet = _random(UNetModel(unet_cfg, device=device, dtype=get_policy().param_dtype), seed,
                   device)
    clip = _random(CLIPTextModel(OPEN_CLIP_H, device=device, dtype=torch.float32), seed + 1,
                   device)
    vae = _random(AutoencoderKL(SD_VAE, device=device, dtype=torch.float32), seed + 2, device)
    return SDModel(unet=unet, unet_cfg=unet.cfg, vae=vae, vae_cfg=vae.cfg,
                   disc=Discretization(make_alphas_cumprod()),
                   conditioner=TextConditioner(clip, OPEN_CLIP_H, get_tokenizer(), clip_skip=2),
                   device=device, title="random-sd2-depth.safetensors [0000000000]",
                   kind="sd2", depth_model=create_random_dpt(seed + 4, device))


def _sdxl_conditioner(cfg: CLIPTextConfig, seed: int, device, dtype) -> TextConditioner:
    """An SDXL text encoder: penultimate layer, no final norm."""
    clip = _random(CLIPTextModel(cfg, device=device, dtype=dtype), seed, device)
    return TextConditioner(clip, cfg, get_tokenizer(), clip_skip=2, apply_final_norm=False)


@dataclasses.dataclass(frozen=True)
class _SDXLFamily:
    """The configs, dtype and titles of one SDXL base + refiner pair."""
    unet: UNetConfig
    refiner_unet: UNetConfig
    clip_l: CLIPTextConfig
    clip_g: CLIPTextConfig
    vae: VAEConfig
    dtype: torch.dtype | None         # None: the policy's param_dtype
    title: str
    refiner_title: str


def _build_sdxl(fam: _SDXLFamily, seed: int, device, refiner: bool,
                shared: SDModel | None) -> SDModel:
    """An SDXL base (CLIP-L ⊕ bigG) or refiner (bigG alone) of `fam`.  UNet
    and text encoders in `fam.dtype`; VAE in fp32.  shared: a base model
    whose bigG conditioner and VAE the refiner takes instead of making its
    own, as the JAX bench does (bench.py:476-477)."""
    device = get_device(device)
    dtype = fam.dtype or get_policy().param_dtype
    if shared is not None:
        cond_g, vae = shared.conditioner2, shared.vae
    else:
        cond_g = _sdxl_conditioner(fam.clip_g, seed + 3, device, dtype)
        vae = _random(AutoencoderKL(fam.vae, device=device, dtype=torch.float32),
                      seed + 2, device)
    unet_cfg = fam.refiner_unet if refiner else fam.unet
    unet = _random(UNetModel(unet_cfg, device=device, dtype=dtype), seed, device)
    common = dict(unet=unet, unet_cfg=unet.cfg, vae=vae, vae_cfg=vae.cfg,
                  disc=Discretization(make_alphas_cumprod()), device=device)
    if refiner:
        return SDModel(**common, conditioner=cond_g, kind="sdxl-refiner",
                       title=fam.refiner_title)
    return SDModel(**common, conditioner=_sdxl_conditioner(fam.clip_l, seed + 1, device, dtype),
                   conditioner2=cond_g, kind="sdxl", title=fam.title)


_RANDOM_SDXL = _SDXLFamily(SDXL_UNET, SDXL_REFINER_UNET, CLIP_L, OPEN_CLIP_BIGG, SDXL_VAE,
                           None, "random-sdxl.safetensors [0000000000]",
                           "random-sdxl-refiner.safetensors [0000000001]")


def create_random_sdxl(seed: int = 0, device="cuda", refiner: bool = False,
                       shared: SDModel | None = None) -> SDModel:
    """Random-weight SDXL base (2816-wide adm) or refiner (2560-wide adm) at
    full width: the compute graph of BASELINE config 5 (sd_model.py:338-381).
    UNet and text encoders in the policy's param_dtype (bf16); VAE in fp32."""
    return _build_sdxl(_RANDOM_SDXL, seed, device, refiner, shared)


TINY_UNET = UNetConfig(model_channels=32, channel_mult=(1, 2),
                       attention_resolutions=(2, 1), transformer_depth=(1, 1),
                       context_dim=64, num_heads=4)
TINY_VAE = VAEConfig(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
TINY_CLIP = CLIPTextConfig(width=64, layers=2, heads=4)


#: the tiny DPT of the JAX package's tests (tests/test_midas.py)
TINY_DPT = DPTConfig(image_size=64, stem_width=32, stage_blocks=(1, 1, 1),
                     stage_widths=(64, 128, 256), vit_width=64, vit_layers=2, vit_heads=4,
                     hooks=(0, 1), features=32, head_width=8)


def create_tiny_sd(seed: int = 0, device="cpu", in_channels: int = 4) -> SDModel:
    """Miniature model for CI-speed end-to-end runs (64×64 images); the
    configs of the JAX package's ``create_tiny_sd``.  in_channels 9, 8 or 5
    make the hybrid variants as the JAX tests make them (the tiny UNet
    with that many input channels; 5 adds a tiny MiDaS tower)."""
    device = get_device(device)
    f32 = torch.float32
    unet_cfg = dataclasses.replace(TINY_UNET, in_channels=in_channels)
    unet = _random(UNetModel(unet_cfg, device=device, dtype=f32), seed, device)
    clip = _random(CLIPTextModel(TINY_CLIP, device=device, dtype=f32), seed + 1, device)
    vae = _random(AutoencoderKL(TINY_VAE, device=device, dtype=f32), seed + 2, device)
    model = _bundle(unet, vae, clip, TINY_CLIP, device, "tiny-test-model [0000000000]",
                    Discretization(make_alphas_cumprod()))
    if in_channels == 5:
        model.depth_model = create_random_dpt(seed + 4, device, TINY_DPT)
    return model


TINY_SDXL_UNET = UNetConfig(model_channels=32, channel_mult=(1, 2),
                            attention_resolutions=(2,), transformer_depth=(0, 1),
                            context_dim=96, num_heads=4, use_linear_in_transformer=True,
                            adm_in_channels=64 + 6 * 256)
TINY_SDXL_REFINER_UNET = dataclasses.replace(TINY_SDXL_UNET, context_dim=64,
                                             transformer_depth_middle=2,
                                             adm_in_channels=64 + 5 * 256)
TINY_SDXL_VAE = dataclasses.replace(TINY_VAE, scale_factor=0.13025)
TINY_CLIP_L = CLIPTextConfig(width=32, layers=2, heads=2)
TINY_CLIP_G = CLIPTextConfig(width=64, layers=2, heads=2, projection_dim=64)


_TINY_SDXL = _SDXLFamily(TINY_SDXL_UNET, TINY_SDXL_REFINER_UNET, TINY_CLIP_L, TINY_CLIP_G,
                         TINY_SDXL_VAE, torch.float32, "tiny-sdxl-test [0000000000]",
                         "tiny-sdxl-refiner-test [0000000001]")


def create_tiny_sdxl(seed: int = 0, device="cpu", refiner: bool = False,
                     shared: SDModel | None = None) -> SDModel:
    """Miniature SDXL-shaped model (dual encoders, adm vectors, linear
    projections; the configs of the JAX package's ``create_tiny_sdxl``), or
    a miniature refiner (bigG alone, aesthetic-score adm, an explicit
    middle depth), in fp32."""
    return _build_sdxl(_TINY_SDXL, seed, device, refiner, shared)


# --------------------------------------------------------------------------
# weights from the JAX package
# --------------------------------------------------------------------------

def _to_torch(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name.startswith("float8"):
        raise NotImplementedError("fp8 weight storage is not ported yet")
    if a.dtype.name == "bfloat16":     # ml_dtypes leaf: widen for torch
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def state_dict_from_tree(tree: dict) -> dict:
    """A JAX param tree → a torch state dict: the inverse of
    ``loader/convert.convert_leaf`` (convert.py:35-43).  4-D weights
    HWIO → OIHW; 2-D weights (I, O) → (O, I) except embeddings and
    text_projection; biases and norms unchanged."""
    out = {}
    for key, leaf in flatten(tree).items():
        t = _to_torch(leaf)
        if key.endswith(".weight"):
            if t.dim() == 4:
                t = t.permute(3, 2, 0, 1)
            elif t.dim() == 2 and not any(n in key for n in _NO_TRANSPOSE_2D):
                t = t.t()
        out[key] = t.contiguous()
    return out


def _conditioner_from_jax(jax_cond, device) -> TextConditioner:
    """A JAX ``TextConditioner``'s encoder (in its tree's dtype) and its
    clip-skip and final-norm settings."""
    sd = state_dict_from_tree(jax_cond.params)
    clip = CLIPTextModel(jax_cond.cfg, device=device, dtype=next(iter(sd.values())).dtype)
    clip.load_state_dict(sd, strict=True)
    return TextConditioner(clip, jax_cond.cfg, get_tokenizer(), clip_skip=jax_cond.clip_skip,
                           apply_final_norm=jax_cond.apply_final_norm)


def dpt_from_jax(tree: dict, jax_cfg, device="cpu") -> DPTDepthModel:
    """The port's MiDaS tower from a JAX DPT tree (``convert_dpt``'s
    layout: conv HWIO, linear (in, out)) and its ``DPTConfig``: the tree's
    leaves as numpy arrays with the layouts inverted, the port's config
    derived from their shapes with JAX's hooks and head count, fp32,
    standardised once."""
    from sdwebui_tpu_torch.loader.convert import convert_dpt

    sd = {}
    for key, leaf in flatten(tree).items():
        a = np.asarray(leaf, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    flat, cfg = convert_dpt(sd, prefix="")
    cfg = dataclasses.replace(cfg, hooks=tuple(jax_cfg.hooks), vit_heads=jax_cfg.vit_heads)
    tower = DPTDepthModel(cfg, device=get_device(device))
    tower.load_state_dict(flat, strict=True)
    return tower.standardize_()


def from_jax(jax_model, device="cpu") -> SDModel:
    """Build the port's SDModel from a JAX ``SDModel`` (sd1, sd2, sdxl or
    sdxl-refiner, and an SD2-depth model's MiDaS tower).  The UNet and text
    encoders keep their trees' dtypes; the VAE and the tower are fp32.
    Every key of every tree is consumed and every module parameter
    filled: ``load_state_dict(strict=True)``."""
    device = get_device(device)
    unet_sd = state_dict_from_tree(jax_model.unet_params)
    unet = UNetModel(jax_model.unet_cfg, device=device,
                     dtype=next(iter(unet_sd.values())).dtype)
    vae = AutoencoderKL(jax_model.vae_cfg, device=device, dtype=torch.float32)
    unet.load_state_dict(unet_sd, strict=True)
    vae.load_state_dict(state_dict_from_tree(jax_model.vae_params), strict=True)
    disc = Discretization(np.asarray(jax_model.disc.alphas_cumprod),
                          prediction_type=jax_model.disc.prediction_type)
    cond2 = jax_model.conditioner2
    return SDModel(unet=unet, unet_cfg=unet.cfg, vae=vae, vae_cfg=vae.cfg, disc=disc,
                   conditioner=_conditioner_from_jax(jax_model.conditioner, device),
                   conditioner2=None if cond2 is None else _conditioner_from_jax(cond2, device),
                   device=device, title=jax_model.title, sha256=jax_model.sha256,
                   kind=jax_model.kind,
                   depth_model=None if jax_model.depth_params is None else dpt_from_jax(
                       jax_model.depth_params, jax_model.depth_cfg, device))
