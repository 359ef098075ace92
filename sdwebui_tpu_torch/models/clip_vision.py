"""The CLIP vision tower of SD2.1-unclip (open_clip's ViT-H/14) as an ``nn.Module``.

Port of ``sdwebui_tpu/models/clip_vision.py:31-87,144-213``: the ViT image
encoder (patch conv → class token + position embeddings → pre-LN
transformer → post-LN → projected class embedding).  Parameter names are
the HF ``CLIPVisionModel`` keys with ``vision_model.`` stripped, plus
``visual_projection`` (a bias-free linear, (out, in));
:func:`convert_openclip_vision` re-keys an unclip checkpoint's
``embedder.model.visual.*`` tower into them.  The 257-token attention is
plain torch (below the kernel's 1024 keys, as in JAX); the LayerNorms go
through ``ops.norms.layer_norm`` (B5 on CUDA).  :func:`preprocess` restates
the reference's Pillow bicubic resize and centre crop with
``utils/images.resize``.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
from torch import nn

from sdwebui_tpu_torch.models.clip import quick_gelu
from sdwebui_tpu_torch.models.layers import Conv2d, Embedding, LayerNorm, Linear, _normal_, _param
from sdwebui_tpu_torch.ops.attention import attention

# OpenAI CLIP preprocessing constants
_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    projection_dim: int = 768


#: open_clip ViT-H/14, the SD2.1-unclip-h image embedder
VIT_H = CLIPVisionConfig(width=1280, layers=32, heads=16, projection_dim=1024)


class _SelfAttn(nn.Module):
    def __init__(self, w, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.q_proj, self.k_proj = Linear(w, w, **kw), Linear(w, w, **kw)
        self.v_proj, self.out_proj = Linear(w, w, **kw), Linear(w, w, **kw)


class _MLP(nn.Module):
    def __init__(self, w, *, device, dtype):
        super().__init__()
        self.fc1 = Linear(w, 4 * w, device=device, dtype=dtype)
        self.fc2 = Linear(4 * w, w, device=device, dtype=dtype)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class _Layer(nn.Module):
    def __init__(self, w, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1, self.self_attn = LayerNorm(w, **kw), _SelfAttn(w, **kw)
        self.layer_norm2, self.mlp = LayerNorm(w, **kw), _MLP(w, **kw)

    def forward(self, x, heads):
        h = self.layer_norm1(x)
        a = self.self_attn
        o = attention(a.q_proj(h), a.k_proj(h), a.v_proj(h), num_heads=heads)
        x = x + a.out_proj(o)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device, dtype):
        super().__init__()
        n_tok = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = _param((cfg.width,), device, dtype)
        self.patch_embedding = Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size,
                                      padding=0, bias=False, device=device, dtype=dtype)
        self.position_embedding = Embedding(n_tok, cfg.width, 0.01, device=device, dtype=dtype)


class CLIPVisionModel(nn.Module):
    """forward(pixels (B, 3, S, S), CLIP-normalised, normalize=True) → the
    projected class embedding (B, projection_dim), L2-normalised unless
    `normalize` is False (the unclip adm takes it raw)."""

    def __init__(self, cfg: CLIPVisionConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg, **kw)
        self.pre_layrnorm = LayerNorm(cfg.width, **kw)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(_Layer(cfg.width, **kw) for _ in range(cfg.layers))
        self.post_layernorm = LayerNorm(cfg.width, **kw)
        self.visual_projection = Linear(cfg.width, cfg.projection_dim, bias=False, **kw)

    @torch.no_grad()
    def reset_random(self, gen):
        from sdwebui_tpu_torch.models.layers import reset_random

        reset_random(self, gen)
        _normal_(self.embeddings.class_embedding, 0.02, gen)

    def forward(self, pixels, normalize: bool = True):
        emb = self.embeddings
        x = emb.patch_embedding(pixels.to(emb.patch_embedding.weight.dtype))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                     # (B, N, width)
        cls = emb.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight.to(x.dtype)[None]
        x = self.pre_layrnorm(x)
        for layer in self.encoder.layers:
            x = layer(x, self.cfg.heads)
        feat = self.visual_projection(self.post_layernorm(x[:, 0]))
        if not normalize:
            return feat
        return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)


def preprocess(image: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 (H, W, 3) → (1, 3, size, size) CLIP-normalised: Pillow's bicubic
    resize of the short side to `size` and a centre crop (clip_vision.py:87)."""
    from sdwebui_tpu_torch.utils import images as images_util

    img = images_util.to_rgb(images_util.as_hwc(image))
    h, w = img.shape[:2]
    s = size / min(w, h)
    nw, nh = max(round(w * s), size), max(round(h * s), size)
    img = images_util.resize(img, (nw, nh), "bicubic")
    left, top = (nw - size) // 2, (nh - size) // 2
    img = img[top: top + size, left: left + size]
    arr = img.astype(np.float32) / 255.0
    return np.ascontiguousarray(((arr - _MEAN) / _STD).transpose(2, 0, 1)[None])


# --------------------------------------------------------------------------
# conversion (clip_vision.py:144-213)
# --------------------------------------------------------------------------

_RENAMES = (("ln_1.", "layer_norm1."), ("ln_2.", "layer_norm2."),
            ("attn.out_proj.", "self_attn.out_proj."), ("mlp.c_fc.", "mlp.fc1."),
            ("mlp.c_proj.", "mlp.fc2."))

#: open_clip vision towers' head counts (absent from the weights): ViT-B
#: 768/12, ViT-L 1024/16, ViT-H 1280/16 (80-channel heads), ViT-bigG 1664/16
_KNOWN_HEADS = {768: 12, 1024: 16, 1280: 16, 1664: 16}


def convert_openclip_vision(sd: dict, prefix: str = "embedder.model.visual.",
                            verify: bool = True):
    """An open_clip VisionTransformer (an unclip checkpoint's
    FrozenOpenCLIPImageEmbedder tower) → (the port's state dict,
    CLIPVisionConfig): the fused in_proj split into q, k, v along dim 0,
    ``proj`` (applied as x @ W) transposed into the projection linear.  The
    names are checked against ``CLIPVisionModel(cfg)``'s."""
    from sdwebui_tpu_torch.loader.convert import _drop_extras, verify_tree_names

    flat, proj = {}, None
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        sub = k[len(prefix):]
        if sub == "class_embedding":
            flat["embeddings.class_embedding"] = v
        elif sub == "positional_embedding":
            flat["embeddings.position_embedding.weight"] = v
        elif sub == "conv1.weight":
            flat["embeddings.patch_embedding.weight"] = v
        elif sub.startswith("ln_pre."):
            flat["pre_layrnorm." + sub[len("ln_pre."):]] = v
        elif sub.startswith("ln_post."):
            flat["post_layernorm." + sub[len("ln_post."):]] = v
        elif sub == "proj":
            proj = v
        m = re.match(r"transformer\.resblocks\.(\d+)\.(.+)", sub)
        if not m:
            continue
        base, rest = f"encoder.layers.{m.group(1)}.", m.group(2)
        if rest in ("attn.in_proj_weight", "attn.in_proj_bias"):
            kind = rest[len("attn.in_proj_"):]
            for name, part in zip("qkv", v.chunk(3, dim=0)):
                flat[base + f"self_attn.{name}_proj.{kind}"] = part
            continue
        for old, new in _RENAMES:
            if rest.startswith(old):
                flat[base + new + rest[len(old):]] = v
    if proj is None:
        raise ValueError("open_clip visual tower missing 'proj'")
    flat["visual_projection.weight"] = proj.t()
    w = flat["embeddings.patch_embedding.weight"]
    width = int(w.shape[0])
    cfg = CLIPVisionConfig(
        patch_size=int(w.shape[-1]), width=width,
        layers=1 + max(int(k.split(".")[2]) for k in flat if k.startswith("encoder.layers.")),
        heads=_KNOWN_HEADS.get(width, width // 64 if width >= 256 else max(width // 16, 1)),
        projection_dim=int(proj.shape[-1]),
        image_size=int((flat["embeddings.position_embedding.weight"].shape[0] - 1) ** 0.5)
        * int(w.shape[-1]))
    if verify:
        _drop_extras(flat, verify_tree_names(set(flat), "clip_vision", cfg, prefix.rstrip(".")),
                     prefix.rstrip("."))
    return flat, cfg


def convert_clip_vision(sd: dict):
    """An HF ``CLIPModel`` / ``CLIPVisionModelWithProjection`` state dict →
    (the tower's state dict, CLIPVisionConfig) (clip_vision.py:107-141):
    ``vision_model.*`` and ``visual_projection.weight``, the head count
    from the width as JAX derives it (64-channel heads from 256 wide)."""
    flat = {}
    for k, v in sd.items():
        if k.startswith("vision_model.") and not k.endswith("position_ids"):
            flat[k[len("vision_model."):]] = v
        elif k.startswith("visual_projection"):
            flat[k] = v
    w = flat["embeddings.patch_embedding.weight"]
    width = int(w.shape[0])
    cfg = CLIPVisionConfig(
        patch_size=int(w.shape[-1]), width=width,
        layers=1 + max(int(k.split(".")[2]) for k in flat if k.startswith("encoder.layers.")),
        heads=width // 64 if width >= 256 else max(width // 16, 1),
        projection_dim=int(flat["visual_projection.weight"].shape[0]),
        image_size=int((flat["embeddings.position_embedding.weight"].shape[0] - 1) ** 0.5)
        * int(w.shape[-1]))
    return flat, cfg


def openclip_vision_state_dict(model: CLIPVisionModel,
                               prefix: str = "embedder.model.visual.") -> dict:
    """The inverse of :func:`convert_openclip_vision`: the tower's tensors
    under open_clip's keys (what an unclip checkpoint holds)."""
    out = {}
    for name, v in model.state_dict().items():
        if name == "embeddings.class_embedding":
            out["class_embedding"] = v
        elif name == "embeddings.position_embedding.weight":
            out["positional_embedding"] = v
        elif name == "embeddings.patch_embedding.weight":
            out["conv1.weight"] = v
        elif name.startswith("pre_layrnorm."):
            out["ln_pre." + name[len("pre_layrnorm."):]] = v
        elif name.startswith("post_layernorm."):
            out["ln_post." + name[len("post_layernorm."):]] = v
        elif name == "visual_projection.weight":
            out["proj"] = v.t().contiguous()
        else:
            m = re.match(r"encoder\.layers\.(\d+)\.(.+)", name)
            base, rest = f"transformer.resblocks.{m.group(1)}.", m.group(2)
            if rest.startswith("self_attn.") and rest[10] in "qkv" and "out_proj" not in rest:
                continue                                    # fused below
            for old, new in _RENAMES:
                if rest.startswith(new):
                    out[base + old + rest[len(new):]] = v
    sd = model.state_dict()
    for i in range(model.cfg.layers):
        a = f"encoder.layers.{i}.self_attn."
        for kind in ("weight", "bias"):
            out[f"transformer.resblocks.{i}.attn.in_proj_{kind}"] = torch.cat(
                [sd[a + f"{n}_proj.{kind}"] for n in "qkv"], dim=0)
    return {prefix + k: v for k, v in out.items()}


def clip_vision_from_jax(tree: dict, cfg, device="cpu") -> CLIPVisionModel:
    """The port's tower from a JAX tree (``convert_openclip_vision``'s
    layout: the patch conv HWIO, linears (in, out)) and its config."""
    from sdwebui_tpu_torch.pipeline.sd_model import state_dict_from_tree

    sd = state_dict_from_tree(tree)
    model = CLIPVisionModel(CLIPVisionConfig(**dataclasses.asdict(cfg)), device=device,
                            dtype=torch.float32)
    model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    return model
