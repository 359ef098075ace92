"""Architecture configurations for the supported model families.

Replaces the reference's OmegaConf yaml zoo (`configs/*.yaml` +
modules/sd_models_config.py): configs are plain dataclasses; the
architecture sniffer (loader/sniff.py) maps a checkpoint's state-dict
shapes onto one of these, mirroring the key-shape rules of
modules/sd_models.py:379-402.

Copy of ``sdwebui_tpu/models/configs.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    # downsample factors at which transformer blocks appear
    attention_resolutions: Sequence[int] = (4, 2, 1)
    # transformer depth per level (len == len(channel_mult)); SD1/SD2 use 1
    transformer_depth: Sequence[int] = (1, 1, 1, 1)
    context_dim: int = 768
    num_heads: int = 8            # used when num_head_channels == -1
    num_head_channels: int = -1   # SD2/SDXL use 64
    # sgm transformer_depth_middle: middle-block attention depth; -1 = auto
    # (last per-level depth, or 1 when the last level has none — SDXL
    # refiner needs the explicit 4: its ds8 level has no attention)
    transformer_depth_middle: int = -1
    use_linear_in_transformer: bool = False
    adm_in_channels: int = 0      # SDXL: 2816 (pooled text + size/crop embeds)
    dropout: float = 0.0
    tiling: bool = False          # circular conv padding (seamless textures)
    # hypertile (reference extensions-builtin/hypertile): self-attention
    # over h×w tokens runs on spatial tiles of ≤ this many latent pixels
    # per side (0 = off). Deterministic tile split (static shapes for XLA)
    # instead of the reference's per-call random divisors.
    hypertile_tile: int = 0
    # token merging ratio for self-attention (reference
    # opts.token_merging_ratio via tomesd); 0 = off
    tome_ratio: float = 0.0
    # run transformer attention fully in fp32 (reference opts.upcast_attn /
    # --upcast-attn for SD2.1 fp16 overflow; scores+softmax are already
    # fp32 here regardless, this additionally upcasts QKV and PV)
    upcast_attn: bool = False

    def heads_for(self, channels: int) -> int:
        if self.num_head_channels > 0:
            return max(channels // self.num_head_channels, 1)
        return self.num_heads

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    embed_dim: int = 4            # latent channels
    z_channels: int = 4
    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    scale_factor: float = 0.18215  # SDXL: 0.13025; SD3: 1.5305
    shift_factor: float = 0.0      # SD3: 0.0609
    tiling: bool = False


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_length: int = 77
    activation: str = "quick_gelu"   # openai CLIP-L; open_clip uses "gelu"
    # layer whose hidden state feeds the UNet; clip_skip shifts this at
    # runtime (reference sd_hijack_clip.py:352-359)
    final_layer_norm: bool = True
    projection_dim: int = 0          # >0: text_projection present (bigG pooled)


# ---- families -------------------------------------------------------------

SD15_UNET = UNetConfig()
SD15_INPAINT_UNET = dataclasses.replace(SD15_UNET, in_channels=9)
SD15_DEPTH_UNET = dataclasses.replace(SD15_UNET, in_channels=5)
SD15_PIX2PIX_UNET = dataclasses.replace(SD15_UNET, in_channels=8)

SD21_UNET = UNetConfig(
    context_dim=1024, num_head_channels=64, num_heads=-1,
    use_linear_in_transformer=True)
SD21_INPAINT_UNET = dataclasses.replace(SD21_UNET, in_channels=9)

SDXL_UNET = UNetConfig(
    channel_mult=(1, 2, 4), attention_resolutions=(4, 2),
    transformer_depth=(0, 2, 10), context_dim=2048,
    num_head_channels=64, num_heads=-1,
    use_linear_in_transformer=True, adm_in_channels=2816)
SDXL_INPAINT_UNET = dataclasses.replace(SDXL_UNET, in_channels=9)
SDXL_REFINER_UNET = UNetConfig(
    model_channels=384, channel_mult=(1, 2, 4, 4),
    attention_resolutions=(4, 2), transformer_depth=(0, 4, 4, 4),
    transformer_depth_middle=4,
    context_dim=1280, num_head_channels=64, num_heads=-1,
    use_linear_in_transformer=True, adm_in_channels=2560)

SD_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scale_factor=0.13025)

CLIP_L = CLIPTextConfig()
OPEN_CLIP_H = CLIPTextConfig(width=1024, layers=23, heads=16, activation="gelu")
OPEN_CLIP_BIGG = CLIPTextConfig(width=1280, layers=32, heads=20,
                                activation="gelu", projection_dim=1280)
