"""CLIP text encoders (CLIP-L, OpenCLIP-bigG) as an ``nn.Module``.

Port of ``sdwebui_tpu/models/clip.py:26-95``.  Parameter names are the HF
``CLIPTextModel`` keys with ``text_model.`` stripped
(``embeddings.token_embedding``, ``encoder.layers.N.self_attn.q_proj``,
``final_layer_norm``, ...), plus bigG's ``text_projection`` as HF's
``CLIPTextModelWithProjection`` holds it (a bias-free linear, (out, in)).
``encode`` returns the hidden state at the clip-skip layer (with or
without the final norm) and the EOT-pooled final state, projected when the
model has a projection; the 77-token causal attention is plain torch, as
in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.configs import CLIPTextConfig
from sdwebui_tpu_torch.models.layers import Embedding, LayerNorm, Linear


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class SelfAttention(nn.Module):
    def __init__(self, w, heads, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.heads = heads
        self.q_proj = Linear(w, w, **kw)
        self.k_proj = Linear(w, w, **kw)
        self.v_proj = Linear(w, w, **kw)
        self.out_proj = Linear(w, w, **kw)

    def forward(self, x, causal_mask):
        b, s, c = x.shape
        d = c // self.heads

        def heads(t):
            return t.reshape(b, s, self.heads, d).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale.to(x.device)
        p = torch.softmax(scores + causal_mask, dim=-1).to(x.dtype)
        out = torch.matmul(p, v).transpose(1, 2).reshape(b, s, c)
        return self.out_proj(out)


class MLP(nn.Module):
    def __init__(self, w, activation, *, device, dtype):
        super().__init__()
        self.fc1 = Linear(w, w * 4, device=device, dtype=dtype)
        self.fc2 = Linear(w * 4, w, device=device, dtype=dtype)
        self.act = quick_gelu if activation == "quick_gelu" else F.gelu

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = SelfAttention(cfg.width, cfg.heads, **kw)
        self.layer_norm1 = LayerNorm(cfg.width, **kw)
        self.mlp = MLP(cfg.width, cfg.activation, **kw)
        self.layer_norm2 = LayerNorm(cfg.width, **kw)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embeddings = nn.ModuleDict({
            "token_embedding": Embedding(cfg.vocab_size, cfg.width, 0.02, **kw),
            "position_embedding": Embedding(cfg.max_length, cfg.width, 0.01, **kw),
        })
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(EncoderLayer(cfg, **kw)
                                            for _ in range(cfg.layers))
        self.final_layer_norm = LayerNorm(cfg.width, **kw)
        if cfg.projection_dim:
            self.text_projection = Linear(cfg.width, cfg.projection_dim, bias=False, **kw)

    def encode(self, tokens, stop_at_layer: int = 0, apply_final_norm: bool = True,
               inputs_embeds=None):
        """tokens (B, S) int → (hidden (B, S, width), pooled (B, width)).

        stop_at_layer: 0 = all layers (clip_skip 1); n > 0 stops n layers
        before the end (clip_skip n+1).  pooled: final layer, final norm, at
        the EOT token (argmax of the ids), through text_projection when
        the model has one (bigG).  inputs_embeds: the token embeddings to
        use instead of the table's (textual inversion, clip.py:98-118)."""
        s = tokens.shape[1]
        x = self.embeddings["token_embedding"](tokens) if inputs_embeds is None \
            else inputs_embeds
        x = x + self.embeddings["position_embedding"].weight[:s].to(x.dtype)
        causal = torch.triu(torch.full((s, s), -1e9, dtype=torch.float32,
                                       device=x.device), diagonal=1)
        stop_idx = self.cfg.layers - stop_at_layer
        hidden = None
        for i, layer in enumerate(self.encoder.layers):
            x = layer(x, causal)
            if i + 1 == stop_idx:
                hidden = x
        if hidden is None:
            hidden = x
        if apply_final_norm:
            hidden = self.final_layer_norm(hidden)
        final = self.final_layer_norm(x)
        eot = tokens.argmax(dim=-1)
        pooled = final[torch.arange(final.shape[0], device=final.device), eot]
        if self.cfg.projection_dim:
            pooled = self.text_projection(pooled)
        return hidden, pooled
