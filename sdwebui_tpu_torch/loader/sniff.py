"""Architecture sniffing from state-dict keys/shapes.

Copy of ``sdwebui_tpu/loader/sniff.py`` (the state dict holds torch
tensors here); ``tests/test_torch_copies.py`` holds both equal.

Replicates the detection rules of modules/sd_models.py:379-402 and
modules/sd_models_config.py (yaml guessing) without OmegaConf: the
checkpoint IS the config — loader/convert.py derives exact UNet/VAE/CLIP
configs from weight shapes; this module only decides the family.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SniffResult:
    family: str            # sd1 | sd2 | alt | sdxl | sdxl-refiner | sd3
    in_channels: int       # 4 normal, 9 inpaint, 5 depth, 8 pix2pix
    prediction_type: str   # eps | v (best-effort; v needs config/override)
    variant: str = ""      # "" | unclip (crossattn-adm) | depth (hybrid)

    @property
    def is_inpaint(self):
        return self.in_channels == 9


def sniff(sd: dict) -> SniffResult:
    keys = sd.keys()

    if "model.diffusion_model.x_embedder.proj.weight" in keys:
        family = "sd3"
        in_ch = 16
    elif "conditioner.embedders.1.model.ln_final.weight" in keys:
        family = "sdxl"
        in_ch = sd["model.diffusion_model.input_blocks.0.0.weight"].shape[1]
    elif "conditioner.embedders.0.model.ln_final.weight" in keys:
        family = "sdxl-refiner"
        in_ch = sd["model.diffusion_model.input_blocks.0.0.weight"].shape[1]
    elif "cond_stage_model.roberta.embeddings.word_embeddings.weight" in keys:
        # AltDiffusion (BAAI): SD1 UNet/VAE + XLM-R conditioner
        family = "alt"
        in_ch = sd["model.diffusion_model.input_blocks.0.0.weight"].shape[1]
    elif "cond_stage_model.model.transformer.resblocks.0.attn.in_proj_weight" in keys:
        family = "sd2"
        in_ch = sd["model.diffusion_model.input_blocks.0.0.weight"].shape[1]
    elif "model.diffusion_model.input_blocks.0.0.weight" in keys:
        family = "sd1"
        in_ch = sd["model.diffusion_model.input_blocks.0.0.weight"].shape[1]
    else:
        raise ValueError("unrecognized checkpoint: no known diffusion model keys")

    # SD2 conditioning variants (reference picks these via yaml sniffing,
    # modules/sd_models_config.py:78-96; here the weights themselves decide):
    # unclip ships a CLIP-vision embedder + noise-augmentor stats
    # (v2-1-stable-unclip yaml, conditioning_key crossattn-adm); depth2img
    # ships a MiDaS DPT tower (v2-midas-inference yaml, key hybrid, 5ch).
    variant = ""
    if "embedder.model.visual.class_embedding" in keys or \
            "noise_augmentor.data_mean" in keys:
        variant = "unclip"
    elif any(k.startswith("depth_model.") for k in keys) and in_ch == 5:
        variant = "depth"

    # v-prediction cannot be read off the weights for SD2-768; the webui
    # guesses from config files next to the checkpoint. Heuristic: SD2 at
    # 1024-width text encoder with no depth/inpaint channels and 768-trained
    # checkpoints are usually v — callers can override.
    pred = "eps"
    return SniffResult(family=family, in_channels=int(in_ch),
                       prediction_type=pred, variant=variant)
