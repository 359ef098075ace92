"""The data × tensor-parallel diffusion training step (ε-MSE + AdamW).

Port of ``sdwebui_tpu/training/train_step.py``: full fine-tuning of the
UNet (the reference's trainers, textual inversion and hypernetworks, are
``training/textual_inversion`` and ``training/hypernetwork``).  Over a
(data, model) mesh:

- the batch splits over ``data``; each data shard's loss is weighted by
  its share of the batch and the gradients are summed over ``data``
  before the update, so the step is the one-device step on the whole
  batch (JAX's ``jnp.mean`` over the global batch);
- the UNet's projections and convs split over ``model``
  (``parallel/sharding``); the collectives are Megatron's autograd pairs
  (``parallel/collectives``), so each model shard's copy of a replicated
  parameter gets the whole gradient once, not once per shard, and the
  replicated biases a shard uses sliced get theirs summed over ``model``;
- AdamW (``torch.optim.AdamW``, lr 1e-5, weight decay 1e-2: optax.adamw's
  defaults but the weight decay JAX's ``make_optimizer`` sets) updates
  each shard's own tensors.

Every shard's forward runs on its thread; one backward call runs the
whole graph.  The forward runs :func:`training.step.training_ctx`, the
plain attention and LayerNorm (the kernels have no backward), entered once
by the driving thread.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from sdwebui_tpu_torch.parallel.mesh import MeshRuntime, data_group, model_group
from sdwebui_tpu_torch.parallel.sharding import partial_grad_keys, shard_params
from sdwebui_tpu_torch.training.step import ADAM_BETAS, ADAM_EPS, training_ctx


def make_optimizer(lr: float = 1e-5, weight_decay: float = 1e-2):
    """params → AdamW (``train_step.py:26-27``)."""
    return functools.partial(torch.optim.AdamW, lr=lr, weight_decay=weight_decay,
                             betas=ADAM_BETAS, eps=ADAM_EPS)


def diffusion_loss(unet, sqrt_ac, sqrt_1mac, x0, noise, t, ctx):
    """ε-prediction MSE at integer timesteps t (the ldm objective,
    ``train_step.py:30-40``): x0 and noise (B, C, h, w), t (B,) int, ctx
    (B, S, D); fp32 loss."""
    a = sqrt_ac[t][:, None, None, None]
    am = sqrt_1mac[t][:, None, None, None]
    x_t = a * x0 + am * noise
    pred = unet(x_t, t.float(), ctx)
    return torch.mean((pred.float() - noise) ** 2)


def _sum_grads(tensors: list) -> None:
    """Every tensor's .grad set to the sum of all of theirs (in list order,
    on the first one's device)."""
    total = tensors[0].grad.clone()
    for p in tensors[1:]:
        total += p.grad.to(total.device)
    for p in tensors:
        p.grad = total.to(p.grad.device, copy=True)


def make_train_step(rt: MeshRuntime, unet_cfg, disc, optimizer=None):
    """(step, shard_batch, prepare) over `rt`'s mesh:

    - ``prepare(unet)`` → (shards, optimizers): shards[d][m] is data shard
      d's model shard m, a UNet of its own whose parameters train;
    - ``shard_batch({"x0", "noise", "t", "ctx"})`` → one dict per data shard
      on its device (NCHW latents);
    - ``step(shards, optimizers, batch)`` → (shards, optimizers, loss):
      one update in place; the loss is the whole batch's, a 0-d fp32
      tensor."""
    optimizer = optimizer or make_optimizer()
    ac = torch.as_tensor(np.asarray(disc.alphas_cumprod, np.float32))
    sqrt_ac, sqrt_1mac = torch.sqrt(ac), torch.sqrt(1.0 - ac)

    def prepare(unet):
        shards = []
        for devs in rt.grid:
            row = shard_params(unet, devs, share=False) if rt.model_size > 1 \
                else [copy.deepcopy(unet).to(devs[0])]
            for s in row:
                s.requires_grad_(True)
            shards.append(row)
        return shards, [[optimizer(s.parameters()) for s in row] for row in shards]

    def shard_batch(batch):
        parts = {k: rt.shard_batch(torch.as_tensor(v)) for k, v in batch.items()}
        return [{k: parts[k][d] for k in batch} for d in range(rt.data_size)]

    def step(shards, optimizers, batch):
        total = sum(b["x0"].shape[0] for b in batch)

        def data_shard(d):
            def model_shard(m):
                dev = rt.grid[d][m]
                b = {k: v.to(dev, copy=m > 0) for k, v in batch[d].items()}
                return diffusion_loss(shards[d][m], sqrt_ac.to(dev), sqrt_1mac.to(dev),
                                      b["x0"], b["noise"], b["t"], b["ctx"])

            return model_group(rt, d).run(model_shard)

        for row in shards:
            for s in row:
                s.zero_grad(set_to_none=True)
        with training_ctx(), torch.enable_grad():
            losses = data_group(rt).run(data_shard)
        weights = [b["x0"].shape[0] / total for b in batch]
        torch.autograd.backward([w * loss for w, row in zip(weights, losses) for loss in row])
        params = [[dict(s.named_parameters()) for s in row] for row in shards]
        if rt.model_size > 1:
            for k in partial_grad_keys(shards[0][0].split_dims):
                for row in params:
                    _sum_grads([named[k] for named in row])
        if rt.data_size > 1:
            for m in range(rt.model_size):
                for k in params[0][m]:
                    _sum_grads([row[m][k] for row in params])
        for row in optimizers:
            for opt in row:
                opt.step()
        loss = sum(w * row[0].detach().to(losses[0][0].device) for w, row in zip(weights, losses))
        return shards, optimizers, loss

    return step, shard_batch, prepare

