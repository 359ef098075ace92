"""SD3's MMDiT (Esser et al. 2024, "Scaling Rectified Flow Transformers") as
an ``nn.Module``.

Port of ``sdwebui_tpu/models/mmdit.py``.  Parameter names are the
``model.diffusion_model.*`` checkpoint keys:

    x_embedder.proj            2x2 patch conv (16 -> hidden), stride 2
    pos_embed                  (1, max_size², hidden) learned, centre-cropped
    t_embedder.mlp.{0,2}       sinusoid(256) -> hidden MLP
    y_embedder.mlp.{0,2}       pooled text (2048) -> hidden MLP
    context_embedder           Linear(4096 -> hidden)
    joint_blocks.N.{context_block,x_block}.
        attn.{qkv,proj} [.ln_q/.ln_k rms]  adaLN_modulation.1  mlp.{fc1,fc2}
    final_layer.{adaLN_modulation.1, linear}

The last block's context side is pre-only: 2 modulations, no MLP and, in
the published files, no ``attn.proj`` (the JAX package's random init has
one; ``pre_only_proj`` holds it, unused, so such a tree loads whole).
Each block's joint attention runs once on the token-axis concatenation of
the context's and the image's q, k, v, as (B, S_ctx + S_img, H·D) through
``ops.attention.attention`` (B2 on CUDA from 1024 keys); the non-affine
LayerNorms (eps 1e-6) go through ``ops.norms.layer_norm`` (B5 on CUDA).
Latents are NCHW, as everywhere in the port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import (Conv2d, Linear, _normal_, _param, linear,
                                             reset_random, timestep_embedding)
from sdwebui_tpu_torch.ops.attention import attention
from sdwebui_tpu_torch.ops.norms import layer_norm
from sdwebui_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    patch_size: int = 2
    in_channels: int = 16
    depth: int = 24                  # sd3-medium; hidden = 64·depth
    context_dim: int = 4096
    pooled_dim: int = 2048
    pos_embed_max_size: int = 192
    qk_norm: bool = False            # SD3.5's rms q/k norm

    @property
    def hidden(self) -> int:
        return 64 * self.depth

    @property
    def num_heads(self) -> int:
        return self.depth


#: SD3-medium at the published widths
SD3_MEDIUM = MMDiTConfig()


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def rms_norm(x, weight=None, eps: float = 1e-6):
    """RMS norm over the last dim in fp32, cast back to x's dtype."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, c, *, device, dtype):
        super().__init__()
        self.weight = _param((c,), device, dtype)

    def forward(self, x):
        return rms_norm(x, self.weight)

    @torch.no_grad()
    def reset_random(self, gen):
        self.weight.fill_(1.0)


class Attn(nn.Module):
    def __init__(self, hidden, heads, qk_norm: bool, proj: bool, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.qkv = Linear(hidden, 3 * hidden, **kw)
        if proj:
            self.proj = Linear(hidden, hidden, **kw)
        if qk_norm:
            self.ln_q = RMSNorm(hidden // heads, **kw)
            self.ln_k = RMSNorm(hidden // heads, **kw)


class MLP(nn.Module):
    def __init__(self, hidden, *, device, dtype):
        super().__init__()
        self.fc1 = Linear(hidden, 4 * hidden, device=device, dtype=dtype)
        self.fc2 = Linear(4 * hidden, hidden, device=device, dtype=dtype)

    def forward(self, x):
        """Split over ``model`` (``parallel/sharding``), fc1 holds the
        shard's columns and uses its slice of the bias, fc2 its rows; the
        partial products are summed over the model group and fc2's bias is
        added once, after the sum."""
        shard = self.fc1.model_shard
        if shard is None:
            return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        rank, size = shard
        h = linear(collectives.copy_to_model(x), self.fc1.weight,
                   self.fc1.bias.chunk(size)[rank])
        out = collectives.reduce_from_model(linear(F.gelu(h, approximate="tanh"),
                                                   self.fc2.weight))
        return out + self.fc2.bias.to(out.dtype)


class DismantledBlock(nn.Module):
    """One side (context or image) of a joint block (mmdit.py:61-87)."""

    def __init__(self, cfg: MMDiTConfig, pre_only: bool, proj: bool = True, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        hd = cfg.hidden
        self.heads = cfg.num_heads
        self.pre_only = pre_only
        self.attn = Attn(hd, cfg.num_heads, cfg.qk_norm, proj or not pre_only, **kw)
        self.adaLN_modulation = nn.ModuleDict({"1": Linear(hd, hd * (2 if pre_only else 6),
                                                           **kw)})
        if not pre_only:
            self.mlp = MLP(hd, **kw)

    def pre_attention(self, x, c_silu):
        """(q, k, v, mods) after the adaLN-modulated norm."""
        mods = self.adaLN_modulation["1"](c_silu).chunk(2 if self.pre_only else 6, dim=-1)
        h = modulate(layer_norm(x, eps=1e-6), mods[0], mods[1])
        q, k, v = self.attn.qkv(h).chunk(3, dim=-1)
        if hasattr(self.attn, "ln_q"):
            b, s, hd = q.shape
            d = hd // self.heads
            q = self.attn.ln_q(q.reshape(b, s, self.heads, d)).reshape(b, s, hd)
            k = self.attn.ln_k(k.reshape(b, s, self.heads, d)).reshape(b, s, hd)
        return q, k, v, mods

    def post_attention(self, attn_out, x, mods):
        gate_msa, shift_mlp, scale_mlp, gate_mlp = mods[2:6]
        x = x + gate_msa[:, None] * self.attn.proj(attn_out)
        h = modulate(layer_norm(x, eps=1e-6), shift_mlp, scale_mlp)
        return x + gate_mlp[:, None] * self.mlp(h)


class JointBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, last: bool, pre_only_proj: bool, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.context_block = DismantledBlock(cfg, last, pre_only_proj, **kw)
        self.x_block = DismantledBlock(cfg, False, **kw)
        self.heads = cfg.num_heads

    def forward(self, context, x, c_silu):
        cq, ck, cv, cmods = self.context_block.pre_attention(context, c_silu)
        xq, xk, xv, xmods = self.x_block.pre_attention(x, c_silu)
        sc = context.shape[1]
        out = attention(torch.cat([cq, xq], dim=1), torch.cat([ck, xk], dim=1),
                        torch.cat([cv, xv], dim=1), num_heads=self.heads)
        x = self.x_block.post_attention(out[:, sc:], x, xmods)
        if not self.context_block.pre_only:
            context = self.context_block.post_attention(out[:, :sc], context, cmods)
        return context, x


class _EmbedMLP(nn.Module):
    def __init__(self, cin, hidden, *, device, dtype):
        super().__init__()
        self.mlp = nn.ModuleDict({"0": Linear(cin, hidden, device=device, dtype=dtype),
                                  "2": Linear(hidden, hidden, device=device, dtype=dtype)})

    def forward(self, x):
        return self.mlp["2"](F.silu(self.mlp["0"](x)))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig, *, device, dtype):
        super().__init__()
        self.proj = Conv2d(cfg.in_channels, cfg.hidden, cfg.patch_size, stride=cfg.patch_size,
                           padding=0, device=device, dtype=dtype)


class _FinalLayer(nn.Module):
    def __init__(self, cfg: MMDiTConfig, *, device, dtype):
        super().__init__()
        hd = cfg.hidden
        self.adaLN_modulation = nn.ModuleDict({"1": Linear(hd, 2 * hd, device=device,
                                                           dtype=dtype)})
        self.linear = Linear(hd, cfg.patch_size ** 2 * cfg.in_channels, device=device,
                             dtype=dtype)


def cropped_pos_embed(pos_embed, h_patches: int, w_patches: int, max_size: int):
    """Centre-crop the learned (1, max², hidden) table to the image grid."""
    grid = pos_embed.reshape(max_size, max_size, -1)
    top, left = (max_size - h_patches) // 2, (max_size - w_patches) // 2
    return grid[top: top + h_patches, left: left + w_patches].reshape(
        1, h_patches * w_patches, -1)


class MMDiT(nn.Module):
    """forward(x (B, 16, H, W), timesteps (B,) in [0, 1000], context (B, S,
    context_dim), y (B, pooled_dim)) → the velocity (B, 16, H, W)."""

    def __init__(self, cfg: MMDiTConfig, *, device, dtype, pre_only_proj: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        hd = cfg.hidden
        self.x_embedder = _PatchEmbed(cfg, **kw)
        self.pos_embed = _param((1, cfg.pos_embed_max_size ** 2, hd), device, dtype)
        self.t_embedder = _EmbedMLP(256, hd, **kw)
        self.y_embedder = _EmbedMLP(cfg.pooled_dim, hd, **kw)
        self.context_embedder = Linear(cfg.context_dim, hd, **kw)
        self.joint_blocks = nn.ModuleList(
            JointBlock(cfg, i == cfg.depth - 1, pre_only_proj, **kw) for i in range(cfg.depth))
        self.final_layer = _FinalLayer(cfg, **kw)

    @torch.no_grad()
    def reset_random(self, gen):
        """Random weights with the JAX init's distributions: every layer's,
        then the position table's N(0, 0.01) and the q/k norms' ones."""
        reset_random(self, gen)
        _normal_(self.pos_embed, 0.01, gen)
        for m in self.modules():
            if isinstance(m, RMSNorm):
                m.reset_random(gen)

    def forward(self, x, timesteps, context, y=None):
        cfg = self.cfg
        ps = cfg.patch_size
        b, _, h, w = x.shape
        hp, wp = h // ps, w // ps
        dtype = self.x_embedder.proj.weight.dtype
        xp = self.x_embedder.proj(x.to(dtype))                  # (B, hidden, hp, wp)
        xp = xp.flatten(2).transpose(1, 2)                       # (B, hp·wp, hidden)
        xp = xp + cropped_pos_embed(self.pos_embed, hp, wp, cfg.pos_embed_max_size).to(dtype)
        c = self.t_embedder(timestep_embedding(timesteps, 256).to(dtype))
        if y is not None:
            c = c + self.y_embedder(y.to(dtype))
        c_silu = F.silu(c)
        ctx = self.context_embedder(context.to(dtype))
        for block in self.joint_blocks:
            ctx, xp = block(ctx, xp, c_silu)
        fl = self.final_layer
        shift, scale = fl.adaLN_modulation["1"](c_silu).chunk(2, dim=-1)
        out = fl.linear(modulate(layer_norm(xp, eps=1e-6), shift, scale))
        out_ch = out.shape[-1] // (ps * ps)                      # (B, hp·wp, ps·ps·C)
        out = out.reshape(b, hp, wp, ps, ps, out_ch).permute(0, 5, 1, 3, 2, 4)
        return out.reshape(b, out_ch, hp * ps, wp * ps)


def self_attention_calls(cfg: MMDiTConfig, latent: int, context_tokens: int) -> list:
    """(S, H, D) of each joint attention of one forward at a latent of
    latent² with context_tokens tokens: depth calls at S = (latent/ps)² +
    context_tokens."""
    s = (latent // cfg.patch_size) ** 2 + context_tokens
    return [(s, cfg.num_heads, 64)] * cfg.depth


def layer_norm_calls(cfg: MMDiTConfig) -> int:
    """LayerNorms (B5 launches) of one forward: two a side of every block
    but the last context side (one, pre-only), plus the final layer's."""
    return 4 * cfg.depth - 1 + 1


def mmdit_from_jax(tree: dict, cfg, device="cpu") -> MMDiT:
    """The port's MMDiT from a JAX MMDiT tree (``init_params``' layout: the
    patch conv HWIO, linears (in, out)) and its config, in the tree's
    dtype; every leaf fills a parameter."""
    from sdwebui_tpu_torch.pipeline.sd_model import state_dict_from_tree

    sd = state_dict_from_tree(tree)
    port_cfg = MMDiTConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(MMDiTConfig) if hasattr(cfg, f.name)})
    proj = f"joint_blocks.{port_cfg.depth - 1}.context_block.attn.proj.weight" in sd
    model = MMDiT(port_cfg, device=device, dtype=next(iter(sd.values())).dtype,
                  pre_only_proj=proj)
    model.load_state_dict(sd, strict=True)
    return model
