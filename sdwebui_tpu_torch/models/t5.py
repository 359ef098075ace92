"""The T5 v1.1 encoder (T5-XXL), SD3's third text encoder, as an ``nn.Module``.

Port of ``sdwebui_tpu/models/t5.py``.  Parameter names are the HF
``T5EncoderModel`` keys (SD3 files bundle them under
``text_encoders.t5xxl.transformer.``): RMS-norm pre-norm blocks, a
relative-position bucket bias added to the unscaled q·k logits (no 1/√d),
a gated-GELU feed-forward, no biases, and one bias table owned by block 0
and shared by every layer.  The buckets are integer math on the host
(numpy), as in JAX; the (heads, S, S) bias is gathered from the table on
the device.  The attention runs at S = 77 with that additive bias, so it
is plain torch, as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Embedding, Linear, _param


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128


#: T5-XXL v1.1's encoder, the published widths
T5_XXL = T5Config()


def relative_position_bucket(rel: np.ndarray, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket mapping (HF _relative_position_bucket)."""
    ret = np.zeros_like(rel)
    n = -rel
    num_buckets //= 2
    ret += (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


def position_buckets(seq_len: int, cfg: T5Config) -> np.ndarray:
    """(S, S) bucket ids of memory_pos − query_pos."""
    pos = np.arange(seq_len)
    return relative_position_bucket(pos[None, :] - pos[:, None], cfg.rel_buckets,
                                    cfg.rel_max_distance)


def rms_norm(x, weight, eps: float = 1e-6):
    """T5's norm: fp32 mean square, x·rsqrt in fp32 cast to x's dtype, then
    times the weight (t5.py:69-71)."""
    var = x.float().pow(2).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


class _Norm(nn.Module):
    def __init__(self, c, *, device, dtype):
        super().__init__()
        self.weight = _param((c,), device, dtype)

    def forward(self, x):
        return rms_norm(x, self.weight)


class SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, first: bool, *, device, dtype):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = Linear(cfg.d_model, inner, **kw)
        self.k = Linear(cfg.d_model, inner, **kw)
        self.v = Linear(cfg.d_model, inner, **kw)
        self.o = Linear(inner, cfg.d_model, **kw)
        if first:
            self.relative_attention_bias = Embedding(cfg.rel_buckets, cfg.num_heads, 0.02,
                                                     device=device, dtype=dtype)

    def forward(self, x, bias):
        b, s, _ = x.shape
        h, d = self.cfg.num_heads, self.cfg.d_kv

        def heads(t):
            return t.reshape(b, s, h, d).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) + bias.to(x.dtype)[None]
        p = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        return self.o(torch.matmul(p, v).transpose(1, 2).reshape(b, s, h * d))


class DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config, *, device, dtype):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.wi_0 = Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wi_1 = Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wo = Linear(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _AttnLayer(nn.Module):
    def __init__(self, cfg, first, *, device, dtype):
        super().__init__()
        self.SelfAttention = SelfAttention(cfg, first, device=device, dtype=dtype)
        self.layer_norm = _Norm(cfg.d_model, device=device, dtype=dtype)


class _FFLayer(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        self.DenseReluDense = DenseGatedGelu(cfg, device=device, dtype=dtype)
        self.layer_norm = _Norm(cfg.d_model, device=device, dtype=dtype)


class _Block(nn.Module):
    def __init__(self, cfg, first, *, device, dtype):
        super().__init__()
        self.layer = nn.ModuleList([_AttnLayer(cfg, first, device=device, dtype=dtype),
                                    _FFLayer(cfg, device=device, dtype=dtype)])


class T5Encoder(nn.Module):
    """forward(tokens (B, S) int) → the final hidden states (B, S, d_model)."""

    def __init__(self, cfg: T5Config, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        self.shared = Embedding(cfg.vocab_size, cfg.d_model, 0.02, device=device, dtype=dtype)
        self.encoder = nn.Module()
        self.encoder.block = nn.ModuleList(_Block(cfg, i == 0, device=device, dtype=dtype)
                                           for i in range(cfg.num_layers))
        self.encoder.final_layer_norm = _Norm(cfg.d_model, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_random(self, gen):
        """The JAX init's distributions: the layers' (layers.reset_random)
        and unit norms."""
        from sdwebui_tpu_torch.models.layers import reset_random

        reset_random(self, gen)
        for m in self.modules():
            if isinstance(m, _Norm):
                m.weight.fill_(1.0)

    def forward(self, tokens):
        x = self.shared(tokens)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        buckets = torch.as_tensor(position_buckets(tokens.shape[1], self.cfg),
                                  device=table.device)
        bias = table[buckets].permute(2, 0, 1)                    # (heads, S, S)
        for block in self.encoder.block:
            att, ff = block.layer
            x = x + att.SelfAttention(att.layer_norm(x), bias)
            x = x + ff.DenseReluDense(ff.layer_norm(x))
        return self.encoder.final_layer_norm(x)


# --------------------------------------------------------------------------
# conversion (t5.py:111-148)
# --------------------------------------------------------------------------

T5_PREFIXES = ("text_encoders.t5xxl.transformer.", "t5xxl.transformer.", "transformer.")


def derive_t5_config(sd: dict) -> T5Config:
    vocab, d_model = sd["shared.weight"].shape
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.block."))
    buckets, heads = sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"].shape
    inner = sd["encoder.block.0.layer.0.SelfAttention.q.weight"].shape[0]
    d_ff = sd["encoder.block.0.layer.1.DenseReluDense.wi_0.weight"].shape[0]
    return T5Config(vocab_size=int(vocab), d_model=int(d_model), d_kv=int(inner) // int(heads),
                    d_ff=int(d_ff), num_layers=n_layers, num_heads=int(heads),
                    rel_buckets=int(buckets))


def convert_t5(sd: dict, verify: bool = True):
    """An HF / SD3-bundled T5 state dict → (the encoder's state dict,
    T5Config): the SD3 wrapper prefix stripped, ``embed_tokens`` (an alias
    of ``shared``) dropped; no layout transposes.  The names are checked
    against ``T5Encoder(cfg)``'s."""
    from sdwebui_tpu_torch.loader.convert import _drop_extras, verify_tree_names

    for pre in T5_PREFIXES:
        if any(k.startswith(pre + "shared.") for k in sd):
            sd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
            break
    flat = {k: v for k, v in sd.items() if "embed_tokens" not in k}
    cfg = derive_t5_config(flat)
    if verify:
        _drop_extras(flat, verify_tree_names(set(flat), "t5", cfg, "t5xxl"), "t5xxl")
    return flat, cfg


def t5_from_jax(tree: dict, cfg, device="cpu") -> T5Encoder:
    """The port's encoder from a JAX T5 tree (linears (in, out)) and its
    config, in the tree's dtype; every leaf fills a parameter."""
    from sdwebui_tpu_torch.pipeline.sd_model import state_dict_from_tree

    sd = state_dict_from_tree(tree)
    # the bucket table and the embedding keep their (rows, cols) layout
    for key in list(sd):
        if "relative_attention_bias" in key or key == "shared.weight":
            sd[key] = sd[key].t().contiguous()
    model = T5Encoder(T5Config(**dataclasses.asdict(cfg)), device=device,
                      dtype=next(iter(sd.values())).dtype)
    model.load_state_dict(sd, strict=True)
    return model
