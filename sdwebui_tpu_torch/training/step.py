"""What the two trainers share: the plain-path context, the family check,
the ε-prediction loss and optax's Adam as ``torch.optim``.

Port of ``sdwebui_tpu/ops/attention.py:44-55`` (``training_attention_ctx``)
and of the loss bodies of ``sdwebui_tpu/training/textual_inversion.py:56-76``
and ``hypernetwork.py:140-152``.  The kernels of ``ops/`` have no backward
(their outputs carry no ``grad_fn``, and ``ops.refuse_autograd`` raises
when a tensor that needs one reaches them), so every training forward runs
:func:`training_ctx`: plain attention and plain LayerNorm, as JAX traces
its losses on the einsum attention and its jnp LayerNorm.  Latents are
NCHW here; the noise is drawn in JAX's NHWC order and transposed, so one
seed gives both packages the same noise.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from sdwebui_tpu_torch.ops.attention import forced_impl
from sdwebui_tpu_torch.ops.norms import forced_plain
from sdwebui_tpu_torch.utils.options import opts

#: optax.adam's and optax.adamw's constants (β1, β2, ε outside the root)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
#: optax.adamw's default weight decay (torch's AdamW defaults to 1e-2)
ADAMW_WEIGHT_DECAY = 1e-4


@contextlib.contextmanager
def training_ctx():
    """Plain attention and plain LayerNorm for the forward inside the block.

    opts.training_xattention_optimizations asks JAX to differentiate
    through its Pallas kernel, which fails on the TPU; the port's kernels
    have no backward either, so the option raises, naming itself."""
    if opts.get("training_xattention_optimizations", False):
        raise NotImplementedError(
            "training_xattention_optimizations: the attention and LayerNorm kernels have no "
            "backward, so training runs the plain paths only (set the option False)")
    with forced_impl("plain"), forced_plain():
        yield


def check_trainable(model) -> None:
    """The families the JAX trainers train: SD1.x and SD2.x, one CLIP, a
    4-channel UNet with no vector conditioning.  Others raise, naming
    what the model is."""
    if model.kind not in ("sd1", "sd2"):
        raise NotImplementedError(f"training a {model.kind!r} model is not ported (SD1.x and "
                                  "SD2.x with one CLIP encoder only, as the JAX trainers)")
    if model.unet_cfg.adm_in_channels or model.is_depth or model.is_unclip \
            or model.unet_cfg.in_channels != model.latent_channels:
        raise NotImplementedError(
            f"training {model.title!r} is not ported: its UNet takes "
            f"{model.unet_cfg.in_channels} input channels or vector conditioning")


def nhwc_noise(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    """N(0, 1) noise for NCHW latents of `shape`, drawn in the JAX
    package's (B, h, w, C) order."""
    b, c, h, w = shape
    return rng.standard_normal((b, h, w, c)).astype(np.float32).transpose(0, 3, 1, 2)


def diffusion_loss(model, latents, noise, t, context, weights, hypernet=None):
    """mean(((UNet(q_sample(latents, t, noise)) − noise)² · weights)) in fp32:
    latents, noise and weights (B, C, h, w), t (B,) int, context (B, S, D).
    The UNet runs in the latents' dtype (its weights cast to it, as JAX's
    layers cast theirs)."""
    ac = torch.as_tensor(np.asarray(model.disc.alphas_cumprod, np.float32),
                         device=latents.device)
    a = torch.sqrt(ac)[t][:, None, None, None]
    am = torch.sqrt(1.0 - ac)[t][:, None, None, None]
    x_t = a * latents + am * noise
    pred = model.unet(x_t, t.float(), context, hypernet=hypernet)
    return torch.mean((pred.float() - noise) ** 2 * weights)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of the next step (optax.inject_hyperparams)."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
