"""The loaded-model bundle: UNet + VAE + text encoder + discretization.

Port of ``sdwebui_tpu/pipeline/sd_model.py:29-113,319-335,445-464``.  The
bundle holds ``nn.Module``s on one explicit device.  Random weights come
from an explicit ``torch.Generator`` on that device, with the
distributions of the JAX package's ``HostInit`` (normal·1/√fan_in, zero
bias, unit norms); the bits differ from JAX's.  ``from_jax`` carries a JAX
model's weights across, so both packages can run on identical parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sdwebui_tpu.models.configs import (CLIP_L, SD15_UNET, SD_VAE,
                                        CLIPTextConfig, UNetConfig, VAEConfig)
from sdwebui_tpu.text.tokenizer import get_tokenizer
from sdwebui_tpu.utils.pytree import flatten
from sdwebui_tpu_torch.models.clip import CLIPTextModel
from sdwebui_tpu_torch.models.layers import reset_random
from sdwebui_tpu_torch.models.unet import UNetModel
from sdwebui_tpu_torch.models.vae import AutoencoderKL
from sdwebui_tpu_torch.sampling.discretization import (Discretization,
                                                       make_alphas_cumprod)
from sdwebui_tpu_torch.text.conditioner import TextConditioner
from sdwebui_tpu_torch.utils.devices import get_device, get_policy

# 2-D leaves stored (rows, width) in both layouts (loader/convert.py:25)
_NO_TRANSPOSE_2D = ("token_embedding", "position_embedding", "positional_embedding",
                    "text_projection")


@dataclasses.dataclass
class SDModel:
    unet: UNetModel
    unet_cfg: UNetConfig
    vae: AutoencoderKL
    vae_cfg: VAEConfig
    disc: Discretization
    conditioner: TextConditioner
    device: torch.device
    title: str = "random-sd15"
    sha256: str = ""

    @property
    def latent_channels(self) -> int:
        return self.vae_cfg.embed_dim

    def encode_texts(self, texts):
        """texts → (N, S, D) crossattn conds."""
        cond, _ = self.conditioner.encode(texts)
        return cond


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
                       prediction_type: str = "eps") -> SDModel:
    """Random-weight SD1.5 at full width: the same compute graph as a real
    checkpoint.  UNet in `dtype` (default: the policy's param_dtype); VAE
    and CLIP in fp32, as in JAX."""
    device = get_device(device)
    dtype = dtype or get_policy().param_dtype
    unet = _random(UNetModel(SD15_UNET, device=device, dtype=dtype), seed, device)
    clip = _random(CLIPTextModel(CLIP_L, device=device, dtype=torch.float32),
                   seed + 1, device)
    vae = _random(AutoencoderKL(SD_VAE, device=device, dtype=torch.float32),
                  seed + 2, device)
    return _bundle(unet, vae, clip, CLIP_L, device, "random-sd15.safetensors [0000000000]",
                   Discretization(make_alphas_cumprod(), prediction_type=prediction_type))


TINY_UNET = UNetConfig(model_channels=32, channel_mult=(1, 2),
                       attention_resolutions=(2, 1), transformer_depth=(1, 1),
                       context_dim=64, num_heads=4)
TINY_VAE = VAEConfig(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
TINY_CLIP = CLIPTextConfig(width=64, layers=2, heads=4)


def create_tiny_sd(seed: int = 0, device="cpu") -> SDModel:
    """Miniature model for CI-speed end-to-end runs (64×64 images); the
    configs of the JAX package's ``create_tiny_sd``."""
    device = get_device(device)
    f32 = torch.float32
    unet = _random(UNetModel(TINY_UNET, device=device, dtype=f32), seed, device)
    clip = _random(CLIPTextModel(TINY_CLIP, device=device, dtype=f32), seed + 1, device)
    vae = _random(AutoencoderKL(TINY_VAE, device=device, dtype=f32), seed + 2, device)
    return _bundle(unet, vae, clip, TINY_CLIP, device, "tiny-test-model [0000000000]",
                   Discretization(make_alphas_cumprod()))


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


def from_jax(jax_model, device="cpu") -> SDModel:
    """Build the port's SDModel from a JAX ``SDModel`` (or any object with
    its ``unet_params/unet_cfg/vae_params/vae_cfg/conditioner/disc/title/
    sha256`` fields).  The UNet keeps the tree's dtype.  Every key of every
    tree is consumed and every module parameter filled:
    ``load_state_dict(strict=True)``."""
    device = get_device(device)
    unet_sd = state_dict_from_tree(jax_model.unet_params)
    unet = UNetModel(jax_model.unet_cfg, device=device,
                     dtype=next(iter(unet_sd.values())).dtype)
    vae = AutoencoderKL(jax_model.vae_cfg, device=device, dtype=torch.float32)
    clip_cfg = jax_model.conditioner.cfg
    clip = CLIPTextModel(clip_cfg, device=device, dtype=torch.float32)
    unet.load_state_dict(unet_sd, strict=True)
    vae.load_state_dict(state_dict_from_tree(jax_model.vae_params), strict=True)
    clip.load_state_dict(state_dict_from_tree(jax_model.conditioner.params), strict=True)
    disc = Discretization(np.asarray(jax_model.disc.alphas_cumprod),
                          prediction_type=jax_model.disc.prediction_type)
    model = _bundle(unet, vae, clip, clip_cfg, device, jax_model.title, disc)
    model.sha256 = jax_model.sha256
    return model
