"""The loaded-model bundle: UNet + VAE + text encoder(s) + discretization.

Port of ``sdwebui_tpu/pipeline/sd_model.py:29-113,223-300,319-464``
for SD1.x, SD2.x (SD2-depth's MiDaS tower, SD2.1-unclip's ViT and
``unclip_adm``), the SDXL base and refiner, AltDiffusion (XLM-R) and SD3
(the MMDiT, CLIP-L ⊕ bigG and an optional T5-XXL) (a checkpoint file's
bundle comes from ``loader/load.py``).  The bundle holds ``nn.Module``s
on one explicit device.  Random weights come
from an explicit ``torch.Generator`` on that device, with the
distributions of the JAX package's ``HostInit`` (normal·1/√fan_in, zero
bias, unit norms); the bits differ from JAX's.  ``from_jax`` carries a JAX
model's weights across, so both packages can run on identical parameters.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from sdwebui_tpu_torch.models.clip import CLIPTextModel
from sdwebui_tpu_torch.models.configs import (CLIP_L, OPEN_CLIP_BIGG, OPEN_CLIP_H,
                                              SD15_UNET, SD21_UNET, SD_VAE,
                                              SDXL_REFINER_UNET, SDXL_UNET, SDXL_VAE,
                                              CLIPTextConfig, UNetConfig, VAEConfig)
from sdwebui_tpu_torch.models.layers import reset_random, timestep_embedding
from sdwebui_tpu_torch.models.midas import DPTConfig, DPTDepthModel, create_random_dpt
from sdwebui_tpu_torch.models.unet import UNetModel, state_dict_depths
from sdwebui_tpu_torch.models.vae import AutoencoderKL
from sdwebui_tpu_torch.parallel.mesh import (cached, check_device_type, drop_replicas,
                                             get_runtime, on_device)
from sdwebui_tpu_torch.parallel.sharding import TensorParallelUNet, shard_params
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
    kind: str = "sd1"                     # sd1 | sd2 | sdxl | sdxl-refiner | sd3 | alt
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
    # SD3's third text encoder (T5-XXL) with its config and tokenizer
    # (text -> 77 ids), when loaded and sd3_enable_t5
    t5: torch.nn.Module | None = None
    t5_cfg: object = None
    t5_tokenizer: object = None
    # SD2.1-unclip: the open_clip ViT and the noise augmentor's
    # {"mean": (D,), "std": (D,)} data statistics
    image_embedder: torch.nn.Module | None = None
    noise_aug_stats: dict | None = None
    # fp8 storage with opts.cache_fp16_weight: the high-precision UNet
    # weights by parameter name, in host RAM, while the UNet holds fp8
    unet_hp: dict | None = None
    # the mesh this bundle was replicated over (:meth:`replicate`), else the
    # process's runtime decides (parallel.mesh.runtime_for)
    runtime: object = None

    @property
    def is_sdxl(self) -> bool:
        return self.kind.startswith("sdxl")

    @property
    def is_sd3(self) -> bool:
        return self.kind == "sd3"

    @property
    def is_unclip(self) -> bool:
        """crossattn-adm conditioning (SD2.1-unclip)."""
        return self.image_embedder is not None

    @property
    def is_depth(self) -> bool:
        """hybrid depth conditioning (SD2-depth, 5-channel UNet)."""
        return self.depth_model is not None

    @property
    def latent_channels(self) -> int:
        return self.vae_cfg.embed_dim

    def to(self, device) -> "SDModel":
        """Move every module to `device` (in place; parks a displaced
        checkpoint in host RAM with "cpu").  Merged LoRA copies and the
        modules' mesh replicas are dropped, never moved."""
        self.network_cache.clear()
        drop_replicas(self.unet, self.vae, *(getattr(c, "model", None)
                                             for c in (self.conditioner, self.conditioner2)))
        self.device = torch.device(device)
        for cond in (self.conditioner, self.conditioner2):
            if cond is not None:
                cond.model.to(self.device)
        for module in (self.unet, self.vae, self.embedded_vae, self.depth_model, self.t5,
                       self.image_embedder):
            if module is not None:
                module.to(self.device)
        if self.noise_aug_stats is not None:
            self.noise_aug_stats = {k: v.to(self.device) for k, v in self.noise_aug_stats.items()}
        return self

    def replicate(self, rt=None) -> "SDModel":
        """This bundle for generation over `rt` (default: the process's
        runtime): each data shard gets its UNet (split over ``model`` when
        the mesh has a model axis > 1), its VAE and its conditioners
        (``sdwebui_tpu/pipeline/sd_model.py:139-169``).  A copy: the source
        bundle, its conditioners and its modules stay as they are.  The
        shards are made here and kept in ``parallel.mesh``'s replica cache
        while their source modules live; the sampler makes them on demand
        as well, so a bundle that was not replicated (or whose LoRA
        merge is new) runs sharded all the same."""
        rt = rt or get_runtime()
        check_device_type(rt, self.device)
        if rt.n_devices <= 1:
            return self
        new = dataclasses.replace(self, runtime=rt)
        # dataclasses.replace shares the conditioner objects: copy them, so
        # the replica never changes the source's
        new.conditioner = copy.copy(self.conditioner)
        if self.conditioner2 is not None:
            new.conditioner2 = copy.copy(self.conditioner2)
        shard_bundles(new, rt, rt.data_size)
        return new

    def encode_texts(self, texts, target_chunks=None):
        """texts → (N, S, D) crossattn conds, or (conds, pooled) for SDXL and
        SD3 (sd_model.py:71-113): the SDXL base concatenates CLIP-L and bigG
        on features and pools bigG; the refiner has bigG alone.  SD3: CLIP-L
        ⊕ bigG on features, zero-padded to the MMDiT's context width, then
        T5's context on the token axis when T5 and its tokenizer are loaded
        (without T5 the joint sequence is CLIP's 77 tokens, as in JAX);
        pooled = CLIP-L's ⊕ bigG's (2048)."""
        cond, pooled = self.conditioner.encode(texts, target_chunks=target_chunks)
        if self.kind == "sd3":
            cond2, pooled2 = self.conditioner2.encode(texts, target_chunks=target_chunks)
            lg = torch.cat([cond, cond2], dim=-1)
            lg = F.pad(lg, (0, self.unet_cfg.context_dim - lg.shape[-1]))
            if self.t5 is not None and self.t5_tokenizer is not None:
                ids = torch.as_tensor([self.t5_tokenizer(t) for t in texts], dtype=torch.int64,
                                      device=lg.device)
                lg = torch.cat([lg, self.t5(ids).to(lg.dtype)], dim=1)
            return lg, torch.cat([pooled, pooled2], dim=-1)
        if self.kind == "sdxl":
            cond2, pooled = self.conditioner2.encode(texts, target_chunks=target_chunks)
            return torch.cat([cond, cond2], dim=-1), pooled
        if self.kind == "sdxl-refiner":
            return cond, pooled
        return cond


def _conditioner_on(cond, device):
    if cond is None:
        return None
    model = on_device(cond.model, device)
    if model is cond.model:
        return cond
    new = copy.copy(cond)
    new.model = model
    return new


def shard_bundles(model: SDModel, rt, n_data: int) -> list:
    """Data shard d's bundle for d < n_data, on its device ``rt.grid[d][0]``:
    its UNet (a ``TensorParallelUNet`` over ``rt.grid[d]`` when the model
    axis is > 1), its VAE and its conditioners.  A shard on the source's
    device shares the source's modules (read-only); others get copies,
    cached while the source modules live (``parallel.mesh.on_device``)."""
    out = []
    for d in range(n_data):
        devs = rt.grid[d]
        dev = devs[0]
        if rt.model_size > 1:
            unet = cached(model.unet, ("model_shards", rt, d), lambda devs=devs: TensorParallelUNet(
                shard_params(model.unet, devs), devs))
        else:
            unet = on_device(model.unet, dev)
        out.append(dataclasses.replace(
            model, unet=unet, vae=on_device(model.vae, dev), device=dev, runtime=None,
            conditioner=_conditioner_on(model.conditioner, dev),
            conditioner2=_conditioner_on(model.conditioner2, dev)))
    return out


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


def _full_random(module, seed: int, device):
    """A module whose own ``reset_random`` covers what layers.reset_random
    does not (position tables, class embeddings, RMS norms)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    module.reset_random(gen)
    return module


#: SD3-medium's 16-channel VAE: no quant convs, scale 1.5305, shift 0.0609
SD3_VAE = VAEConfig(embed_dim=16, z_channels=16, scale_factor=1.5305, shift_factor=0.0609)


def create_random_sd3(seed: int = 0, device="cuda", t5: bool = False) -> SDModel:
    """Random-weight SD3-medium at the published widths: the MMDiT (depth
    24, hidden 1536, 24 heads, pos_embed_max_size 192, context 4096,
    pooled 2048) in the policy's param_dtype, the 16-channel VAE in
    vae_dtype, CLIP-L and bigG in fp32 at the penultimate layer without the
    final norm; with `t5`, T5-XXL (d_model 4096, 24 layers, 64 heads, d_ff
    10240, vocab 32128) in param_dtype, which takes token ids: set
    ``t5_tokenizer`` to use it."""
    from sdwebui_tpu_torch.models.mmdit import SD3_MEDIUM, MMDiT
    from sdwebui_tpu_torch.models.t5 import T5_XXL, T5Encoder
    from sdwebui_tpu_torch.sampling.discretization import FlowDiscretization

    device = get_device(device)
    dtype = get_policy().param_dtype
    unet = _full_random(MMDiT(SD3_MEDIUM, device=device, dtype=dtype), seed, device)
    vae = _random(AutoencoderKL(SD3_VAE, device=device, dtype=get_policy().vae_dtype,
                                quant_conv=False), seed + 2, device)
    f32 = torch.float32
    clip_l = _random(CLIPTextModel(CLIP_L, device=device, dtype=f32), seed + 1, device)
    clip_g = _random(CLIPTextModel(OPEN_CLIP_BIGG, device=device, dtype=f32), seed + 3, device)
    model = SDModel(
        unet=unet, unet_cfg=SD3_MEDIUM, vae=vae, vae_cfg=SD3_VAE,
        disc=FlowDiscretization(shift=3.0),
        conditioner=TextConditioner(clip_l, CLIP_L, get_tokenizer(), clip_skip=2,
                                    apply_final_norm=False),
        conditioner2=TextConditioner(clip_g, OPEN_CLIP_BIGG, get_tokenizer(), clip_skip=2,
                                     apply_final_norm=False),
        device=device, title="random-sd3-medium.safetensors [0000000000]", kind="sd3")
    if t5:
        model.t5 = _full_random(T5Encoder(T5_XXL, device=device, dtype=dtype), seed + 5, device)
        model.t5_cfg = T5_XXL
    return model


def create_random_sd2_unclip(seed: int = 0, device="cuda") -> SDModel:
    """Random-weight SD2.1-unclip-h at the published widths: the SD2 UNet
    with a 2048-wide adm (ViT-H's 1024-wide embedding ⊕ the noise level's
    1024-wide sinusoid), OpenCLIP-H at clip skip 2, the SD VAE, the
    open_clip ViT-H/14 image embedder (fp32) and unit noise statistics.
    UNet in the policy's param_dtype."""
    from sdwebui_tpu_torch.models.clip_vision import VIT_H, CLIPVisionModel

    device = get_device(device)
    unet_cfg = dataclasses.replace(SD21_UNET, adm_in_channels=2 * VIT_H.projection_dim)
    unet = _random(UNetModel(unet_cfg, device=device, dtype=get_policy().param_dtype), seed,
                   device)
    clip = _random(CLIPTextModel(OPEN_CLIP_H, device=device, dtype=torch.float32), seed + 1,
                   device)
    vae = _random(AutoencoderKL(SD_VAE, device=device, dtype=torch.float32), seed + 2, device)
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    stats = {"mean": 0.1 * torch.randn(VIT_H.projection_dim, generator=gen, device=device),
             "std": 1.0 + 0.1 * torch.rand(VIT_H.projection_dim, generator=gen, device=device)}
    return SDModel(unet=unet, unet_cfg=unet_cfg, vae=vae, vae_cfg=SD_VAE,
                   disc=Discretization(make_alphas_cumprod()),
                   conditioner=TextConditioner(clip, OPEN_CLIP_H, get_tokenizer(), clip_skip=2),
                   device=device, title="random-sd21-unclip-h.safetensors [0000000000]",
                   kind="sd2", noise_aug_stats=stats,
                   image_embedder=_full_random(CLIPVisionModel(VIT_H, device=device,
                                                               dtype=torch.float32),
                                               seed + 4, device))


def create_random_alt(seed: int = 0, device="cuda", tokenizer=None) -> SDModel:
    """Random-weight AltDiffusion at the published widths: the SD1.5 UNet
    and VAE with XLM-R large (24 layers, width 1024, 16 heads, vocab
    250002) and its 768-wide projection as the conditioner (fp32); the UNet
    in the policy's param_dtype.  `tokenizer`: text → XLM-R ids."""
    from sdwebui_tpu_torch.models.xlmr import XLMR_LARGE, AltConditioner, XLMRModel

    device = get_device(device)
    unet = _random(UNetModel(SD15_UNET, device=device, dtype=get_policy().param_dtype), seed,
                   device)
    vae = _random(AutoencoderKL(SD_VAE, device=device, dtype=torch.float32), seed + 2, device)
    xlmr = _random(XLMRModel(XLMR_LARGE, device=device, dtype=torch.float32), seed + 1, device)
    return SDModel(unet=unet, unet_cfg=SD15_UNET, vae=vae, vae_cfg=SD_VAE,
                   disc=Discretization(make_alphas_cumprod()),
                   conditioner=AltConditioner(xlmr, XLMR_LARGE, tokenizer), device=device,
                   title="random-altdiffusion.safetensors [0000000000]", kind="alt")


def unclip_adm(model: SDModel, images=None, noise_level: int = 0, seed: int = 0):
    """The unclip model's adm vector (sd_model.py:261-300): img2img: the
    ViT's raw projected embedding of the first init image, normalised by
    the noise augmentor's statistics, noised to `noise_level` with
    Philox(seed) noise (ldm's CLIPEmbeddingNoiseAugmentation; the reference
    uses level 0), un-normalised, and the level's sinusoid embedding
    appended; txt2img (no images): zeros.  One (adm_in_channels,) fp32
    vector on the model's device."""
    from sdwebui_tpu_torch.models.clip_vision import preprocess
    from sdwebui_tpu_torch.rng.philox import PhiloxGenerator

    adm_ch = int(model.unet_cfg.adm_in_channels)
    if images is None:
        return torch.zeros((adm_ch,), dtype=torch.float32, device=model.device)
    cfg = model.image_embedder.cfg
    dim = adm_ch - cfg.projection_dim
    pixels = torch.from_numpy(preprocess(images[0], cfg.image_size)).to(model.device)
    emb = model.image_embedder(pixels, normalize=False).float()             # (1, D)
    mean = model.noise_aug_stats["mean"].reshape(1, -1)
    std = model.noise_aug_stats["std"].reshape(1, -1)
    x = (emb - mean) / std
    ac = float(make_alphas_cumprod()[noise_level])
    noise = torch.from_numpy(PhiloxGenerator(seed).randn(tuple(x.shape))).to(model.device)
    z = (ac ** 0.5) * x + ((1.0 - ac) ** 0.5) * noise
    z = z * std + mean
    lvl = timestep_embedding(torch.tensor([float(noise_level)], device=model.device), dim)
    return torch.cat([z, lvl], dim=-1)[0]


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
                shared: SDModel | None, in_channels: int = 4) -> SDModel:
    """An SDXL base (CLIP-L ⊕ bigG) or refiner (bigG alone) of `fam`.  UNet
    and text encoders in `fam.dtype`; VAE in fp32.  shared: a base model
    whose bigG conditioner and VAE the refiner takes instead of making its
    own, as the JAX bench does (bench.py:476-477).  in_channels 9: the
    SDXL inpainting UNet's layout."""
    device = get_device(device)
    dtype = fam.dtype or get_policy().param_dtype
    if shared is not None:
        cond_g, vae = shared.conditioner2, shared.vae
    else:
        cond_g = _sdxl_conditioner(fam.clip_g, seed + 3, device, dtype)
        vae = _random(AutoencoderKL(fam.vae, device=device, dtype=torch.float32),
                      seed + 2, device)
    unet_cfg = dataclasses.replace(fam.refiner_unet if refiner else fam.unet,
                                   in_channels=in_channels)
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
                       shared: SDModel | None = None, in_channels: int = 4) -> SDModel:
    """Random-weight SDXL base (2816-wide adm) or refiner (2560-wide adm) at
    full width: the compute graph of BASELINE config 5 (sd_model.py:338-381);
    in_channels 9: the SDXL inpainting model's.  UNet and text encoders in
    the policy's param_dtype (bf16); VAE in fp32."""
    return _build_sdxl(_RANDOM_SDXL, seed, device, refiner, shared, in_channels)


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


def create_tiny_sd3(seed: int = 0, device="cpu") -> SDModel:
    """Miniature SD3 in fp32 (the configs of the JAX package's
    ``create_tiny_sd3``): an MMDiT of depth 2 on a 96-wide context, a tiny
    16-channel VAE, tiny CLIP-L and bigG, the flow schedule."""
    from sdwebui_tpu_torch.models.mmdit import MMDiT, MMDiTConfig
    from sdwebui_tpu_torch.sampling.discretization import FlowDiscretization

    device = get_device(device)
    f32 = torch.float32
    cfg = MMDiTConfig(depth=2, context_dim=96, pooled_dim=96, pos_embed_max_size=16)
    vae_cfg = dataclasses.replace(TINY_VAE, embed_dim=16, z_channels=16, scale_factor=1.5305,
                                  shift_factor=0.0609)
    return SDModel(
        unet=_full_random(MMDiT(cfg, device=device, dtype=f32), seed, device), unet_cfg=cfg,
        vae=_random(AutoencoderKL(vae_cfg, device=device, dtype=f32), seed + 2, device),
        vae_cfg=vae_cfg, disc=FlowDiscretization(shift=3.0),
        conditioner=_sdxl_conditioner(TINY_CLIP_L, seed + 1, device, f32),
        conditioner2=_sdxl_conditioner(TINY_CLIP_G, seed + 3, device, f32),
        device=device, title="tiny-sd3-test [0000000000]", kind="sd3")


def create_tiny_sdxl(seed: int = 0, device="cpu", refiner: bool = False,
                     shared: SDModel | None = None, in_channels: int = 4) -> SDModel:
    """Miniature SDXL-shaped model (dual encoders, adm vectors, linear
    projections; the configs of the JAX package's ``create_tiny_sdxl``), or
    a miniature refiner (bigG alone, aesthetic-score adm, an explicit
    middle depth), in fp32."""
    return _build_sdxl(_TINY_SDXL, seed, device, refiner, shared, in_channels)


# --------------------------------------------------------------------------
# weights from the JAX package
# --------------------------------------------------------------------------

_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _to_torch(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name in _FP8:        # ml_dtypes leaf: its codes, reinterpreted
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8)).view(_FP8[a.dtype.name])
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
    """Build the port's SDModel from a JAX ``SDModel``: sd1, sd2 (with an
    SD2-depth model's MiDaS tower, or an unclip model's ViT and noise
    statistics), sdxl, sdxl-refiner, alt (XLM-R) and sd3 (the MMDiT, and
    T5 with its tokenizer where the JAX model has them).  The UNet, the
    MMDiT, T5 and the CLIP encoders keep their trees' dtypes; the VAE, the
    towers and XLM-R are fp32.  Every key of every tree is consumed and
    every module parameter filled: ``load_state_dict(strict=True)``."""
    device = get_device(device)
    if jax_model.kind == "sd3":
        from sdwebui_tpu_torch.models.mmdit import mmdit_from_jax
        from sdwebui_tpu_torch.sampling.discretization import FlowDiscretization

        unet = mmdit_from_jax(jax_model.unet_params, jax_model.unet_cfg, device)
        disc = FlowDiscretization(shift=jax_model.disc.shift)
    else:
        unet_sd = state_dict_from_tree(jax_model.unet_params)
        unet = UNetModel(jax_model.unet_cfg, device=device,
                         dtype=next(t.dtype for t in unet_sd.values() if t.dtype not in FP8_DTYPES),
                         depths=state_dict_depths(unet_sd))
        unet.load_state_dict(unet_sd, strict=True)
        _keep_fp8(unet, unet_sd)
        disc = Discretization(np.asarray(jax_model.disc.alphas_cumprod),
                              prediction_type=jax_model.disc.prediction_type)
    vae = AutoencoderKL(jax_model.vae_cfg, device=device, dtype=torch.float32)
    vae.load_state_dict(state_dict_from_tree(jax_model.vae_params), strict=True)
    if jax_model.kind == "alt":
        from sdwebui_tpu_torch.models.xlmr import AltConditioner, XLMRConfig, xlmr_from_jax

        jc = jax_model.conditioner
        xlmr = xlmr_from_jax(jc.params, jc.cfg, device)
        cond = AltConditioner(xlmr, XLMRConfig(**dataclasses.asdict(jc.cfg)), jc.tokenizer,
                              jc.max_length)
    else:
        cond = _conditioner_from_jax(jax_model.conditioner, device)
    cond2 = jax_model.conditioner2
    model = SDModel(unet=unet, unet_cfg=unet.cfg, vae=vae, vae_cfg=vae.cfg, disc=disc,
                    conditioner=cond,
                    conditioner2=None if cond2 is None else _conditioner_from_jax(cond2, device),
                    device=device, title=jax_model.title, sha256=jax_model.sha256,
                    kind=jax_model.kind,
                    depth_model=None if jax_model.depth_params is None else dpt_from_jax(
                        jax_model.depth_params, jax_model.depth_cfg, device))
    if jax_model.t5_params is not None:
        from sdwebui_tpu_torch.models.t5 import t5_from_jax

        model.t5 = t5_from_jax(jax_model.t5_params, jax_model.t5_cfg, device)
        model.t5_cfg, model.t5_tokenizer = model.t5.cfg, jax_model.t5_tokenizer
    if jax_model.image_embedder_params is not None:
        from sdwebui_tpu_torch.models.clip_vision import clip_vision_from_jax

        model.image_embedder = clip_vision_from_jax(jax_model.image_embedder_params,
                                                    jax_model.image_embedder_cfg, device)
        model.noise_aug_stats = {k: torch.as_tensor(np.array(v, np.float32), device=device)
                                 .reshape(-1) for k, v in jax_model.noise_aug_stats.items()}
    return model


# --------------------------------------------------------------------------
# fp8 weight storage (sd_model.py:467-517)
# --------------------------------------------------------------------------

FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def _keep_fp8(unet: torch.nn.Module, sd: dict) -> None:
    """Store the fp8 tensors of `sd` as they are: ``load_state_dict``
    copies them into the module's dtype."""
    params = dict(unet.named_parameters())
    for name, t in sd.items():
        if t.dtype in FP8_DTYPES:
            params[name].data = t.to(params[name].device)


def _fp8_quantizable(name: str, p: torch.Tensor) -> bool:
    """Conv and linear weights (2-D and up, not of a norm): what
    quantize_unet_fp8 stores in fp8 (sd_model.py:483-486)."""
    return (name.endswith(".weight") and p.dim() >= 2
            and p.dtype in (torch.bfloat16, torch.float32, torch.float16)
            and "norm" not in name.rsplit(".", 2)[-2])


def has_fp8(model: SDModel) -> bool:
    return any(p.dtype == torch.float8_e4m3fn for p in model.unet.parameters())


def quantize_unet_fp8(model: SDModel, keep_hp: bool = False) -> SDModel:
    """Store the UNet's conv and linear weights as float8_e4m3fn on the
    device (opts.fp8_storage; norms, biases and embeddings stay as they
    are); the forward upcasts each at use.  keep_hp (opts.cache_fp16_weight)
    keeps host copies of the original weights: LoRA merges take them as
    their base, and ``dequantize_unet_fp8`` restores them exactly.  In
    place; merged LoRA copies are dropped."""
    hp = {}
    for name, p in model.unet.named_parameters():
        if _fp8_quantizable(name, p):
            if keep_hp:
                hp[name] = p.detach().to("cpu", copy=True)
            fmt = torch.channels_last if p.dim() == 4 else torch.contiguous_format
            p.data = p.data.to(torch.float8_e4m3fn).contiguous(memory_format=fmt)
    model.unet_hp = hp if keep_hp else None
    model.network_cache.clear()
    drop_replicas(model.unet)
    return model


def dequantize_unet_fp8(model: SDModel, dtype=torch.bfloat16) -> SDModel:
    """Undo fp8 storage from the kept copies (exact) or, without them, by
    upcasting the stored codes to `dtype` (lossy, as the reference without a
    checkpoint reload).  In place; merged LoRA copies are dropped."""
    hp = model.unet_hp or {}
    for name, p in model.unet.named_parameters():
        if p.dtype == torch.float8_e4m3fn:
            src = hp.get(name)
            fmt = torch.channels_last if p.dim() == 4 else torch.contiguous_format
            new = src.to(p.device) if src is not None else p.data.to(dtype)
            p.data = new.contiguous(memory_format=fmt)
    model.unet_hp = None
    model.network_cache.clear()
    drop_replicas(model.unet)
    return model
