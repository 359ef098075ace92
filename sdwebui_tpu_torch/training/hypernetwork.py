"""Hypernetwork training: the k/v MLPs learn, the model stays frozen.

Port of ``sdwebui_tpu/training/hypernetwork.py:16-49,98-261``.  The loss is
the weighted ε-prediction MSE of ``training/step.py`` with the network in
every attention, under ``training_ctx`` (plain attention and LayerNorm);
each caption's conditioning is encoded under it too, so a step launches
no kernel.  The optimizer is ``torch.optim.AdamW`` with optax.adamw's
constants, its weight decay 1e-4 (optax's default, not torch's 1e-2), the
learning rate set before every step from the schedule.  Dropout, when the
structure asks for it, draws its masks from a ``torch.Generator`` seeded
with seed + 1 (JAX folds the step into a threefry key of seed + 1: the
masks differ, their rates do not), and runs in the training forward only.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from sdwebui_tpu_torch.networks.hypernetwork import (Hypernetwork, create_hypernetwork,
                                                     parse_dropout_structure, save_hypernetwork)
from sdwebui_tpu_torch.training.step import (ADAM_BETAS, ADAM_EPS, ADAMW_WEIGHT_DECAY,
                                             check_trainable, diffusion_loss, nhwc_noise,
                                             set_lr, training_ctx)
from sdwebui_tpu_torch.utils.png import encode_png

log = logging.getLogger(__name__)


def hn_parameters(hn: Hypernetwork) -> list:
    """Every tensor of the network, in its layers' order."""
    return [t for pair in hn.layers.values() for mod in pair for layer in mod
            for t in layer.values()]


def make_hn_train_step(model, activation: str = "linear", lr: float = 1e-4,
                       dropout_structure=None, generator: torch.Generator | None = None):
    """(step, init).  init(hn) → AdamW over the network's tensors (made
    leaves that require grad).  step(hn, optimizer, latents, noise, t,
    context, weights=None) → the loss of one AdamW update in place.
    dropout_structure: per-position probabilities, drawn from `generator`
    in the training forward."""
    check_trainable(model)
    dropping = dropout_structure is not None and any(dropout_structure)

    def step(hn, optimizer, latents, noise, t, context, weights=None):
        live = Hypernetwork(hn.layers, activation, dropout=(tuple(dropout_structure), generator)
                            if dropping else None)
        if weights is None:
            weights = torch.ones_like(latents)
        t = torch.as_tensor(np.asarray(t), dtype=torch.long).to(latents.device)
        optimizer.zero_grad(set_to_none=True)
        with training_ctx():
            loss = diffusion_loss(model, latents, noise, t, context, weights, hypernet=live)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def init(hn):
        params = hn_parameters(hn)
        for p in params:
            p.requires_grad_(True)
        return torch.optim.AdamW(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                                 weight_decay=ADAMW_WEIGHT_DECAY)

    return step, init


def train_hypernetwork_from_dir(model, name: str, data_root: str, dims=None,
                                layer_structure=(1, 2, 1), activation: str = "linear",
                                weight_init: str = "Normal", add_layer_norm: bool = False,
                                use_dropout: bool = False, last_layer_dropout: bool = True,
                                dropout_structure=None, steps: int = 100,
                                learn_rate="0.00001", batch_size: int = 1,
                                template: str = "hypernetwork", width: int = 512,
                                height: int = 512, varsize: bool = False,
                                use_weight: bool = False, shuffle_tags: bool = False,
                                tag_drop_out: float = 0.0, latent_sampling_method: str = "once",
                                seed: int = 0, save_path: str | None = None,
                                save_every: int = 0, callback=None, preview_every: int = 0,
                                preview_prompt: str | None = None, preview_steps: int = 8,
                                preview_size: tuple = (256, 256)):
    """A directory of images → (the trained Hypernetwork, losses): a new
    network (create_hypernetwork at `seed`) trained on the dataset's
    captions, saved every save_every steps and at the end, with previews
    every preview_every steps.  callback(i, loss) returning False stops
    the run after step i."""
    from sdwebui_tpu_torch.training.dataset import LearnRateScheduler, PersonalizedDataset
    from sdwebui_tpu_torch.training.textual_inversion import vae_parked

    check_trainable(model)
    if dims is None:
        dims = (model.unet_cfg.context_dim,)
    ds = PersonalizedDataset(data_root, model, width=width, height=height, placeholder=name,
                             template=template, varsize=varsize, use_weight=use_weight,
                             shuffle_tags=shuffle_tags, tag_drop_out=tag_drop_out,
                             latent_sampling_method=latent_sampling_method, seed=seed)
    schedule = LearnRateScheduler(learn_rate, steps)
    hn = create_hypernetwork(dims=dims, layer_structure=layer_structure, seed=seed,
                             weight_init=weight_init, add_layer_norm=add_layer_norm,
                             activation=activation, device=model.device)
    if dropout_structure is None:
        dropout_structure = parse_dropout_structure(layer_structure, use_dropout,
                                                    last_layer_dropout)
    dropping = any(dropout_structure)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(seed + 1)
    step_fn, init_fn = make_hn_train_step(model, activation, schedule.learn_rate,
                                          dropout_structure, generator)
    optimizer = init_fn(hn)
    rng = np.random.default_rng(seed)
    saved_structure = dropout_structure if dropping else None
    losses = []
    with vae_parked(model):
        for i in range(steps):
            set_lr(optimizer, schedule.rate_at(i))
            latents, texts, weights = ds.sample_batch(batch_size)
            with training_ctx(), torch.no_grad():
                context = model.encode_texts(texts).clone()
            noise = torch.from_numpy(nhwc_noise(rng, tuple(latents.shape))).to(latents.device)
            t = rng.integers(0, len(model.disc.alphas_cumprod), (latents.shape[0],))
            losses.append(float(step_fn(hn, optimizer, latents, noise, t, context, weights)))
            if callback is not None and callback(i, losses[-1]) is False:
                break
            if save_every and save_path and (i + 1) % save_every == 0 and (i + 1) < steps:
                save_hypernetwork(hn, save_path, name=name, step=i + 1,
                                  layer_structure=layer_structure,
                                  dropout_structure=saved_structure)
            if preview_every and save_path and (i + 1) % preview_every == 0:
                with vae_parked(model, False):
                    _save_hn_preview(model, name, hn, i + 1, save_path,
                                     preview_prompt or texts[0], preview_steps, preview_size,
                                     seed)
    for p in hn_parameters(hn):
        p.requires_grad_(False)
    if save_path:
        save_hypernetwork(hn, save_path, name=name, step=len(losses),
                          layer_structure=layer_structure, dropout_structure=saved_structure)
    return hn, losses


def _save_hn_preview(model, name: str, hn: Hypernetwork, step: int, save_path: str,
                     prompt: str, steps: int, size: tuple, seed: int):
    """A txt2img with the network as it stands (no dropout), saved as
    ``<save dir>/images/<name>-<step>.png``."""
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.pipeline.processing import process_txt2img

    try:
        live = Hypernetwork({d: tuple([{k: t.detach() for k, t in layer.items()}
                                       for layer in mod] for mod in pair)
                             for d, pair in hn.layers.items()}, hn.activation)
        res = process_txt2img(model, GenerationParams(
            prompt=prompt, seed=seed, steps=steps, width=size[0], height=size[1],
            hypernet_override=live))
        out_dir = os.path.join(os.path.dirname(save_path) or ".", "images")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{name}-{step}.png"), "wb") as f:
            f.write(encode_png(res.images[0]))
    except Exception:
        log.exception("hypernetwork preview of %s at step %d failed", name, step)
