"""Textual-inversion training: the embedding is the one trainable tensor.

Port of ``sdwebui_tpu/training/textual_inversion.py:24-102,152-415``.
Each step splices the (vectors, width) embedding into CLIP's input
embeddings at the placeholder of its caption, encodes, noises the latents
(q-sample), runs the UNet and takes the weighted ε-prediction MSE
(``training/step.py``), all under ``training_ctx``: plain attention and
plain LayerNorm, the kernels have no backward.  The optimizer is
``torch.optim.Adam`` with optax's constants, its learning rate set before
every step from the schedule (optax.inject_hyperparams).  The ``.optim``
file keeps JAX's layout: ``leaf0`` the step count (int32), ``leaf1`` and
``leaf2`` the first and second moments, optax's flatten order, so a state
saved by either package loads in the other.  JAX writes the 0-d count as
shape (1,) and its loader, which wants shape (), keeps its fresh count of
0 (the moments load, the bias correction restarts); the port reads the
count.  The families JAX trains
(SD1.x and SD2.x, one CLIP) train here; others raise, naming the family.

Unlike JAX, which drops every exception of the embedding card and the
preview (``except Exception: pass``), the port logs them.  The card
carries the name and step as JAX draws them (``utils/text_raster``) and
the same data panels.
"""

from __future__ import annotations

import csv
import logging
import os

import numpy as np
import torch

from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict, write_safetensors
from sdwebui_tpu_torch.networks.image_embedding import insert_image_data_embed
from sdwebui_tpu_torch.networks.textual_inversion import Embedding
from sdwebui_tpu_torch.text.tokenizer import BOS, EOS
from sdwebui_tpu_torch.training.step import (ADAM_BETAS, ADAM_EPS, check_trainable,
                                             diffusion_loss, nhwc_noise, set_lr, training_ctx)
from sdwebui_tpu_torch.utils import text_raster
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import encode_png

log = logging.getLogger(__name__)

#: the card's background (textual_inversion.py:377)
CARD_COLOUR = (32, 38, 48)


def prepare_tokens(tokenizer, template: str, placeholder_vectors: int, max_len: int = 77):
    """A template with "{}" → (77 token ids, the placeholder's position)."""
    before, _, after = template.partition("{}")
    ids_before = tokenizer.encode(before)
    ids_after = tokenizer.encode(after)
    pos = 1 + len(ids_before)
    ids = [BOS] + ids_before + [0] * placeholder_vectors + ids_after
    ids = ids[: max_len - 1] + [EOS] * (max_len - len(ids)) + [EOS]
    return np.asarray(ids[:max_len], np.int32), pos


def tokens_for_caption(tokenizer, caption: str, placeholder: str, n_vectors: int,
                       max_len: int = 77):
    """A dataset caption → (77 ids, splice position): the placeholder word
    takes n_vectors slots (the caption's end when it is absent)."""
    if placeholder in caption:
        before, _, after = caption.partition(placeholder)
    else:
        before, after = caption + " ", ""
    return prepare_tokens(tokenizer, before + "{}" + after, n_vectors, max_len)


def make_ti_train_step(model, tokens: np.ndarray | None = None, splice_pos: int | None = None,
                       n_vectors: int = 1, lr: float = 5e-3):
    """(step, init).  init(emb) → the optimizer over `emb`, a leaf tensor
    that requires grad.  step(emb, optimizer, latents, noise, t, toks (B,
    77), pos (B,), weights) → (emb, optimizer, loss): one Adam update in
    place.  Without toks, every row takes the fixed (tokens, splice_pos).
    step.loss(emb, latents, noise, t, toks, pos, weights) is the loss
    alone, for a caller that wants the gradient."""
    check_trainable(model)
    clip = model.conditioner.model
    table = clip.embeddings["token_embedding"].weight
    fixed = None if tokens is None else torch.as_tensor(np.asarray(tokens), dtype=torch.long)

    def loss_fn(emb, latents, noise, t, toks, pos, weights):
        b, s = toks.shape
        x = table[toks].float()
        # dynamic_update_slice clamps the start so the slice fits
        start = torch.clamp(pos, 0, s - emb.shape[0])
        rows = start[:, None] + torch.arange(emb.shape[0], device=x.device)[None]
        batch = torch.arange(b, device=x.device)[:, None].expand_as(rows)
        x = x.index_put((batch, rows), emb.to(x.dtype)[None].expand(b, -1, -1))
        ctx, _ = clip.encode(toks, inputs_embeds=x)
        return diffusion_loss(model, latents, noise, t, ctx, weights)

    def step(emb, optimizer, latents, noise, t, toks=None, pos=None, weights=None):
        device = emb.device
        b = latents.shape[0]
        if toks is None:
            toks = fixed[None].expand(b, -1)
            pos = torch.full((b,), int(splice_pos), dtype=torch.long)
        if weights is None:
            weights = torch.ones_like(latents)
        toks = torch.as_tensor(np.asarray(toks), dtype=torch.long).to(device)
        pos = torch.as_tensor(np.asarray(pos), dtype=torch.long).to(device)
        t = torch.as_tensor(np.asarray(t), dtype=torch.long).to(device)
        optimizer.zero_grad(set_to_none=True)
        with training_ctx():
            loss = loss_fn(emb, latents, noise, t, toks, pos, weights)
        loss.backward()
        optimizer.step()
        return emb, optimizer, loss.detach()

    def init(emb):
        return torch.optim.Adam([emb], lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)

    step.loss = loss_fn
    return step, init


def train_embedding_from_dir(model, name: str, data_root: str, placeholder: str | None = None,
                             n_vectors: int = 1, steps: int = 100, learn_rate="0.005",
                             batch_size: int = 1, template: str = "subject", width: int = 512,
                             height: int = 512, varsize: bool = False, use_weight: bool = False,
                             shuffle_tags: bool = False, tag_drop_out: float = 0.0,
                             flip_p: float = 0.5, latent_sampling_method: str = "once",
                             seed: int = 0, save_path: str | None = None, save_every: int = 0,
                             log_every: int = 0, initial_vec=None, callback=None,
                             preview_every: int = 0, preview_prompt: str | None = None,
                             preview_steps: int = 8, preview_size: tuple = (256, 256)):
    """A directory of images → (Embedding, losses): captions and
    templates, buckets, the learn-rate schedule, the alpha-weighted loss,
    saves every save_every steps and at the end (``.safetensors``, the PNG
    card, the ``.optim`` state with opts.save_optimizer_state), previews
    every preview_every steps.  callback(i, loss) returning False stops
    the run after step i."""
    from sdwebui_tpu_torch.training.dataset import LearnRateScheduler, PersonalizedDataset

    check_trainable(model)
    placeholder = placeholder or name
    ds = PersonalizedDataset(data_root, model, width=width, height=height,
                             placeholder=placeholder, template=template, flip_p=flip_p,
                             varsize=varsize, use_weight=use_weight, shuffle_tags=shuffle_tags,
                             tag_drop_out=tag_drop_out,
                             latent_sampling_method=latent_sampling_method, seed=seed)
    schedule = LearnRateScheduler(learn_rate, steps)
    step_fn, init_fn = make_ti_train_step(model, n_vectors=n_vectors, lr=schedule.learn_rate)

    cw = model.conditioner.cfg.width
    rng = np.random.default_rng(seed)
    if initial_vec is not None:
        vec = np.asarray(initial_vec, np.float32).reshape(n_vectors, cw)
    else:
        vec = (rng.standard_normal((n_vectors, cw)) * 0.01).astype(np.float32)
    emb = torch.tensor(vec, device=model.device, requires_grad=True)
    optimizer = init_fn(emb)
    if initial_vec is not None and save_path and opts.get("save_optimizer_state", False):
        load_optim_state(optimizer, emb, save_path)
    if save_path and opts.get("save_training_settings_to_txt", True):
        _write_settings_txt(save_path, dict(
            name=name, data_root=data_root, n_vectors=n_vectors, steps=steps,
            learn_rate=learn_rate, batch_size=batch_size, template=template, width=width,
            height=height, varsize=varsize, use_weight=use_weight, shuffle_tags=shuffle_tags,
            tag_drop_out=tag_drop_out, latent_sampling_method=latent_sampling_method,
            seed=seed, num_images=len(ds.entries)))
    tokenizer = model.conditioner.tokenizer
    csv_every = int(opts.get("training_write_csv_every", 500) or 0)
    losses = []
    with vae_parked(model):
        for i in range(steps):
            lr_now = schedule.rate_at(i)
            set_lr(optimizer, lr_now)
            latents, texts, weights = ds.sample_batch(batch_size)
            toks, poss = zip(*[tokens_for_caption(tokenizer, t, placeholder, n_vectors)
                               for t in texts])
            noise = torch.from_numpy(nhwc_noise(rng, tuple(latents.shape))).to(latents.device)
            t = rng.integers(0, len(model.disc.alphas_cumprod), (latents.shape[0],))
            emb, optimizer, loss = step_fn(emb, optimizer, latents, noise, t, np.stack(toks),
                                           np.asarray(poss), weights)
            losses.append(float(loss))
            if callback is not None and callback(i, losses[-1]) is False:
                break
            if log_every and (i + 1) % log_every == 0:
                print(f"[TI {name}] step {i + 1}/{steps} loss {losses[-1]:.4f} lr {lr_now:g}")
            if csv_every and save_path and (i + 1) % csv_every == 0:
                _write_loss_csv(save_path, i + 1, float(np.mean(losses[-csv_every:])),
                                schedule.rate_at(i))
            if save_every and save_path and (i + 1) % save_every == 0 and (i + 1) < steps:
                _save_embedding(name, emb, i + 1, save_path)
                if opts.get("save_optimizer_state", False):
                    save_optim_state(optimizer, emb, save_path)
            if preview_every and save_path and (i + 1) % preview_every == 0:
                with vae_parked(model, False):
                    _save_preview(model, name, emb, i + 1, save_path,
                                  preview_prompt or texts[0], preview_steps, preview_size, seed)
    result = Embedding(name, emb.detach().float().cpu().clone(), step=len(losses))
    if save_path:
        _save_embedding(name, emb, result.step, save_path)
        if opts.get("save_optimizer_state", False):
            save_optim_state(optimizer, emb, save_path)
    return result, losses


class vae_parked:
    """opts.unload_models_when_training: the VAE waits in host RAM while
    the steps run (the dataset encoded every latent before); CLIP stays,
    the embedding trains through it.  ``vae_parked(model, False)`` brings
    it back for the block (a preview decodes)."""

    def __init__(self, model, park: bool = True):
        self.model, self.park = model, park
        self.on = bool(opts.get("unload_models_when_training", False))

    def __enter__(self):
        if self.on:
            self.model.vae.to("cpu" if self.park else self.model.device)

    def __exit__(self, *exc):
        if self.on:
            self.model.vae.to(self.model.device if self.park else "cpu")


def _write_settings_txt(save_path: str, settings: dict):
    """The run's settings in ``<save path stem>_settings.txt``."""
    path = os.path.splitext(save_path)[0] + "_settings.txt"
    try:
        with open(path, "w", encoding="utf8") as f:
            f.write("training settings\n")
            for k, v in settings.items():
                f.write(f"{k}: {v}\n")
    except OSError:
        log.exception("could not write %s", path)


def _write_loss_csv(save_path: str, step: int, loss: float, lr: float):
    """One (step, mean loss, learn rate) row of ``<stem>_loss.csv``."""
    path = os.path.splitext(save_path)[0] + "_loss.csv"
    header = not os.path.exists(path)
    try:
        with open(path, "a", encoding="utf8", newline="") as f:
            w = csv.writer(f)
            if header:
                w.writerow(["step", "loss", "learn_rate"])
            w.writerow([step, f"{loss:.7f}", lr])
    except OSError:
        log.exception("could not write %s", path)


def save_optim_state(optimizer, emb, save_path: str):
    """``<save path>.optim``: optax's Adam state in its flatten order."""
    state = optimizer.state.get(emb) or {}
    step = int(state["step"]) if "step" in state else 0
    zeros = torch.zeros_like(emb, dtype=torch.float32)
    write_safetensors(save_path + ".optim", {
        "leaf0": torch.tensor([step], dtype=torch.int32),    # JAX writes the count as (1,)
        "leaf1": state.get("exp_avg", zeros).detach().float().cpu(),
        "leaf2": state.get("exp_avg_sq", zeros).detach().float().cpu()})


def load_optim_state(optimizer, emb, save_path: str):
    """The moments and step count of ``<save path>.optim`` into the fresh
    `optimizer`; a moment that is missing or of another shape stays zero,
    as in JAX."""
    path = save_path + ".optim"
    if not os.path.exists(path):
        return optimizer
    saved = read_state_dict(path)
    count = saved.get("leaf0")
    leaves = [count if count is not None and count.numel() == 1 else torch.zeros(1)]
    for i in (1, 2):
        s = saved.get(f"leaf{i}")
        leaves.append(s if s is not None and tuple(s.shape) == tuple(emb.shape)
                      else torch.zeros_like(emb))
    optimizer.state[emb] = {
        "step": torch.tensor(float(leaves[0].reshape(())), dtype=torch.float32),
        "exp_avg": leaves[1].to(emb.device, torch.float32).clone(),
        "exp_avg_sq": leaves[2].to(emb.device, torch.float32).clone()}
    return optimizer


def card_image(name: str, vec, step: int) -> np.ndarray:
    """The PNG card's pixels: the embedding's data panels around a 512²
    preview with the name at (24, 230) and ``step {n}`` at (24, 260) in
    Pillow's default font (textual_inversion.py:376-380)."""
    preview = np.empty((512, 512, 3), np.uint8)
    preview[:] = CARD_COLOUR
    font = text_raster.load_default()
    text_raster.draw_text(preview, (24, 230), name, font, (235, 235, 235))
    text_raster.draw_text(preview, (24, 260), f"step {step}", font, (150, 150, 150))
    data = {"string_to_token": {"*": 265}, "string_to_param": {"*": vec}, "name": name,
            "step": step, "sd_checkpoint": None, "sd_checkpoint_name": None}
    return insert_image_data_embed(preview, data)


def _save_embedding(name: str, emb, step: int, save_path: str):
    """The ``.safetensors`` and the PNG card beside it."""
    vec = emb.detach().float().cpu().contiguous()
    write_safetensors(save_path, {"emb_params": vec}, metadata={"name": name, "step": str(step)})
    try:
        with open(os.path.splitext(save_path)[0] + ".png", "wb") as f:
            f.write(encode_png(card_image(name, vec.numpy(), step)))
    except Exception:
        log.exception("embedding card of %s not written", name)


def _save_preview(model, name: str, emb, step: int, save_path: str, prompt: str, steps: int,
                  size: tuple, seed: int):
    """A txt2img with the embedding as it stands, registered in the live
    database, saved as ``<save dir>/images/<name>-<step>.png``."""
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.pipeline.processing import process_txt2img

    try:
        db = model.conditioner.embedding_db
        if db is not None:
            db.register(Embedding(name, emb.detach().float().cpu().clone(), step=step))
        res = process_txt2img(model, GenerationParams(prompt=prompt, seed=seed, steps=steps,
                                                      width=size[0], height=size[1]))
        out_dir = os.path.join(os.path.dirname(save_path) or ".", "images")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{name}-{step}.png"), "wb") as f:
            f.write(encode_png(res.images[0]))
    except Exception:
        log.exception("training preview of %s at step %d failed", name, step)
