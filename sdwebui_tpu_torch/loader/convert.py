"""Checkpoint state dict → the port's module state dicts and configs.

Port of ``sdwebui_tpu/loader/convert.py`` (with SD3's ``convert_mmdit``,
:544-560).  The port's modules hold the
ldm/sgm parameter names and the torch layouts (conv OIHW, linear
(out, in)), so a component's state dict is the checkpoint's keys with the
component prefix stripped: no layout transposes (JAX's ``convert_leaf``)
and no host-side casts.  Kept from JAX: the UNet and VAE config
derivation from weight shapes (with the head-count rule, which the
weights do not record, and the middle-block depth), CLIP's head count,
the HF CLIP prefix handling (``position_ids`` dropped), the open_clip →
HF re-keying (the fused ``in_proj`` split into q, k, v along dim 0;
``logit_scale`` and ``visual.*`` dropped; open_clip's (in, out)
``text_projection`` transposed once into HF's (out, in) linear), and the
structure check: the expected names come from the port's own modules
built on ``device="meta"`` at the derived config, a missing tensor raises
naming it (SSD-1B-style whole pruned groups excepted), and junk keys are
dropped with a warning.
"""

from __future__ import annotations

import functools
import logging
import re

import torch

from sdwebui_tpu_torch.models.configs import CLIPTextConfig, UNetConfig, VAEConfig

log = logging.getLogger("sdwebui_tpu_torch")


def _clip_heads(width: int) -> int:
    """Head count is not in the weights: all production CLIP text towers use
    64-channel heads (L:12, H:16, bigG:20); tiny test widths use 16."""
    return width // 64 if width >= 512 else max(width // 16, 1)


# --------------------------------------------------------------------------
# UNet
# --------------------------------------------------------------------------

def derive_unet_config(sd: dict, prefix: str = "model.diffusion_model.") -> UNetConfig:
    """The UNet's config from its weight shapes (convert.py:59-174)."""
    g = lambda k: sd[prefix + k]   # noqa: E731
    model_channels = int(g("input_blocks.0.0.weight").shape[0])
    in_channels = int(g("input_blocks.0.0.weight").shape[1])
    out_channels = int(g("out.2.weight").shape[0]) \
        if prefix + "out.2.weight" in sd else in_channels

    # walk input blocks: channels + attention depth per block
    block_res = {}       # index -> is resblock
    block_attn_depth = {}
    block_down = set()
    n_blocks = 0
    depth_re = re.compile(
        re.escape(prefix) + r"input_blocks\.(\d+)\.1\.transformer_blocks\.(\d+)\.attn1\.to_q\.weight")
    legacy_re = re.compile(
        re.escape(prefix) + r"input_blocks\.(\d+)\.1\.qkv\.weight")
    legacy_attn = False
    for k in sd:
        if not k.startswith(prefix + "input_blocks."):
            continue
        rest = k[len(prefix) + len("input_blocks."):]
        idx = int(rest.split(".")[0])
        n_blocks = max(n_blocks, idx + 1)
        if rest.split(".")[1] == "0" and "in_layers.2.weight" in rest:
            block_res[idx] = int(sd[k].shape[0])
        if ".0.op.weight" in rest:
            block_down.add(idx)
        m = depth_re.match(k)
        if m:
            i = int(m.group(1))
            block_attn_depth[i] = max(block_attn_depth.get(i, 0), int(m.group(2)) + 1)
        m = legacy_re.match(k)
        if m:
            # context-free LDM AttentionBlock (LDSR's bsr model)
            legacy_attn = True
            block_attn_depth[int(m.group(1))] = \
                max(block_attn_depth.get(int(m.group(1)), 0), 1)

    # levels separated by downsample blocks
    channel_mult = []
    transformer_depth = []
    attention_resolutions = []
    ds = 1
    level_channels = None
    level_depth = 0
    res_per_level = 0
    res_counts = []
    for idx in range(1, n_blocks):
        if idx in block_down:
            channel_mult.append(level_channels // model_channels)
            transformer_depth.append(level_depth)
            if level_depth > 0:
                attention_resolutions.append(ds)
            res_counts.append(res_per_level)
            ds *= 2
            level_channels, level_depth, res_per_level = None, 0, 0
            continue
        if idx in block_res:
            level_channels = block_res[idx]
            res_per_level += 1
        if idx in block_attn_depth:
            level_depth = max(level_depth, block_attn_depth[idx])
    channel_mult.append(level_channels // model_channels)
    transformer_depth.append(level_depth)
    if level_depth > 0:
        attention_resolutions.append(ds)
    res_counts.append(res_per_level)
    # an output block may hold more transformer blocks than its level's
    # input blocks (SSD-1B prunes input_blocks.7 and .8 to 4 and keeps
    # output_blocks.2 at 10): the level's depth is the deepest of either,
    # and the module is built to each block's own (ROADMAP C: JAX takes the
    # input blocks' and drops the rest as unexpected)
    out_re = re.compile(re.escape(prefix)
                        + r"output_blocks\.(\d+)\.1\.transformer_blocks\.(\d+)\.")
    per_level = res_counts[0] + 1
    for k in sd:
        m = out_re.match(k)
        if m:
            level = len(transformer_depth) - 1 - int(m.group(1)) // per_level
            if 0 <= level and transformer_depth[level] > 0:
                transformer_depth[level] = max(transformer_depth[level], int(m.group(2)) + 1)

    # context dim from any cross-attention key projection
    context_dim = None
    use_linear = False
    for k in sd:
        if k.startswith(prefix) and k.endswith("attn2.to_k.weight"):
            context_dim = int(sd[k].shape[1])
        if k.startswith(prefix) and k.endswith(".1.proj_in.weight"):
            use_linear = sd[k].ndim == 2
    adm = 0
    if prefix + "label_emb.0.0.weight" in sd:
        adm = int(sd[prefix + "label_emb.0.0.weight"].shape[1])

    # middle-block depth is independent of the last level's (SDXL refiner:
    # per-level (0,4,4,0) but middle 4 — sgm transformer_depth_middle)
    mid_re = re.compile(re.escape(prefix)
                        + r"middle_block\.1\.transformer_blocks\.(\d+)\.")
    mid_depth = -1
    for k in sd:
        m = mid_re.match(k)
        if m:
            mid_depth = max(mid_depth, int(m.group(1)) + 1)

    # head count is not recorded in the weights: SD1 (ctx 768) uses 8 fixed
    # heads, every later family uses 64-channel heads; sub-64-channel models
    # (tests) get channels/8 per head
    if legacy_attn and context_dim is None:
        hc = 32 if model_channels % 32 == 0 else max(model_channels // 4, 1)
        num_heads, num_head_channels = -1, hc
    elif context_dim == 768:
        num_heads, num_head_channels = 8, -1
    elif model_channels % 64 == 0:
        num_heads, num_head_channels = -1, 64
    else:
        num_heads, num_head_channels = max(model_channels // 8, 1), -1

    return UNetConfig(
        in_channels=in_channels, out_channels=out_channels,
        model_channels=model_channels, num_res_blocks=max(res_counts),
        channel_mult=tuple(channel_mult),
        attention_resolutions=tuple(attention_resolutions),
        transformer_depth=tuple(transformer_depth),
        context_dim=context_dim or 768,
        num_heads=num_heads, num_head_channels=num_head_channels,
        use_linear_in_transformer=use_linear, adm_in_channels=adm,
        transformer_depth_middle=mid_depth)


def derive_vae_config(sd: dict, prefix: str = "first_stage_model.",
                      scale_factor: float = 0.18215) -> VAEConfig:
    ch = int(sd[prefix + "encoder.conv_in.weight"].shape[0])
    if prefix + "post_quant_conv.weight" in sd:
        embed_dim = int(sd[prefix + "post_quant_conv.weight"].shape[1])
        z_channels = int(sd[prefix + "post_quant_conv.weight"].shape[0])
    else:       # SD3's VAE: no quant convs, the decoder takes the latent itself
        embed_dim = z_channels = int(sd[prefix + "decoder.conv_in.weight"].shape[1])
    levels = set()
    blocks = set()
    for k in sd:
        m = re.match(re.escape(prefix) + r"encoder\.down\.(\d+)\.block\.(\d+)\.", k)
        if m:
            levels.add(int(m.group(1)))
            blocks.add(int(m.group(2)))
    ch_mult = []
    for lv in sorted(levels):
        w = sd[prefix + f"encoder.down.{lv}.block.{max(blocks)}.conv2.weight"]
        ch_mult.append(int(w.shape[0]) // ch)
    return VAEConfig(embed_dim=embed_dim, z_channels=z_channels, ch=ch,
                     ch_mult=tuple(ch_mult), num_res_blocks=len(blocks),
                     scale_factor=scale_factor)


# --------------------------------------------------------------------------
# the structure check
# --------------------------------------------------------------------------

def build_module(kind: str, cfg, device="meta", dtype=torch.float32, **kw):
    """The port's module of `kind` ("unet", "mmdit", "vae", "clip", "t5",
    "clip_vision", "controlnet", "dpt", "hed") at `cfg`, with
    uninitialised parameters (no storage on "meta")."""
    if kind == "unet":
        from sdwebui_tpu_torch.models.unet import UNetModel as cls
    elif kind == "mmdit":
        from sdwebui_tpu_torch.models.mmdit import MMDiT as cls
    elif kind == "t5":
        from sdwebui_tpu_torch.models.t5 import T5Encoder as cls
    elif kind == "clip_vision":
        from sdwebui_tpu_torch.models.clip_vision import CLIPVisionModel as cls
    elif kind == "dpt":
        from sdwebui_tpu_torch.models.midas import DPTDepthModel as cls
    elif kind == "hed":
        from sdwebui_tpu_torch.models.hed import ControlNetHED as cls
    elif kind == "controlnet":
        from sdwebui_tpu_torch.models.controlnet import ControlNetModel as cls
    elif kind == "vae":
        from sdwebui_tpu_torch.models.vae import AutoencoderKL as cls
    else:
        from sdwebui_tpu_torch.models.clip import CLIPTextModel as cls
    return cls(cfg, device=device, dtype=dtype, **kw)


@functools.lru_cache(maxsize=16)
def _structure_names(kind: str, cfg, variant: bool = False) -> frozenset:
    """Every parameter name of the port's module at `cfg` (where `variant`:
    a UNet with the legacy AttentionBlocks, an MMDiT whose pre-only last
    context block keeps its ``attn.proj``, a VAE without quant convs): the
    single source of truth for what a checkpoint must provide."""
    kw = {}
    if variant:
        kw = {"mmdit": {"pre_only_proj": True}, "vae": {"quant_conv": False}}.get(
            kind, {"legacy_attention": True})
    return frozenset(build_module(kind, cfg, **kw).state_dict())


# SSD-1B-style pruning removes WHOLE subtrees (reference
# modules/sd_hijack.py:191 convert_sdxl_to_ssd: transformer blocks and the
# middle attention/second res); a missing name is tolerated only when its
# entire prunable group is absent.  Not validated against a real SSD-1B
# checkpoint (convert.py:213-216).
_PRUNABLE_GROUP = re.compile(
    r"((?:input|output)_blocks\.\d+\.1\.transformer_blocks\.\d+\.|"
    r"middle_block\.[12]\.)")


def verify_tree_names(got: set, kind: str, cfg, what: str,
                      variant: bool = False) -> set:
    """Raise when an expected tensor is missing (minus whole pruned
    groups); return the unexpected names for the caller to drop."""
    expected = _structure_names(kind, cfg, variant)
    missing = expected - got
    if missing and kind == "unet":
        def pruned(name):
            m = _PRUNABLE_GROUP.match(name)
            if not m:
                return False
            group = m.group(1)
            return all(e in missing for e in expected if e.startswith(group))

        missing = {n for n in missing if not pruned(n)}
    if missing:
        raise ValueError(
            f"{what}: checkpoint is missing {len(missing)} expected "
            f"tensors, e.g. {sorted(missing)[:4]}")
    return set(got) - expected


def _drop_extras(flat: dict, extra: set, what: str) -> None:
    if not extra:
        return
    log.warning("%s: ignoring %d unexpected checkpoint tensors, e.g. %s",
                what, len(extra), sorted(extra)[:4])
    for k in extra:
        flat.pop(k, None)


def _component(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def is_legacy_unet(flat: dict) -> bool:
    """A context-free LDM UNet (LDSR's bsr model): its attention layers are
    the legacy AttentionBlock's fused qkv (convert.py:264-268)."""
    return any(".1.qkv." in k for k in flat)


def convert_unet(sd: dict, prefix: str = "model.diffusion_model.", verify: bool = True):
    """→ (the UNet's state dict, UNetConfig); a legacy-attention UNet is
    checked against ``UNetModel(cfg, legacy_attention=True)``'s names."""
    cfg = derive_unet_config(sd, prefix)
    flat = _component(sd, prefix)
    if verify:
        _drop_extras(flat, verify_tree_names(set(flat), "unet", cfg, prefix.rstrip("."),
                                             is_legacy_unet(flat)), prefix.rstrip("."))
    return flat, cfg


def convert_vae(sd: dict, prefix: str = "first_stage_model.",
                scale_factor: float = 0.18215, verify: bool = True):
    """→ (the VAE's state dict, VAEConfig); a VAE without quant convs
    (SD3's published files) is checked against ``AutoencoderKL(cfg,
    quant_conv=False)``'s names (build it with :func:`vae_kwargs`)."""
    cfg = derive_vae_config(sd, prefix, scale_factor)
    flat = _component(sd, prefix)
    if verify:
        _drop_extras(flat, verify_tree_names(set(flat), "vae", cfg, prefix.rstrip("."),
                                             bool(vae_kwargs(flat))), prefix.rstrip("."))
    return flat, cfg


def vae_kwargs(flat: dict) -> dict:
    """AutoencoderKL's constructor arguments for a VAE state dict."""
    return {} if "post_quant_conv.weight" in flat else {"quant_conv": False}


# --------------------------------------------------------------------------
# CLIP (HF layout — SD1 / SDXL embedders.0)
# --------------------------------------------------------------------------

def _clip_config(flat: dict, activation: str) -> CLIPTextConfig:
    tok = flat["embeddings.token_embedding.weight"]
    proj = flat.get("text_projection.weight")
    return CLIPTextConfig(
        vocab_size=int(tok.shape[0]), width=int(tok.shape[1]),
        layers=1 + max(int(k.split(".")[2]) for k in flat if k.startswith("encoder.layers.")),
        heads=_clip_heads(int(tok.shape[1])),
        max_length=int(flat["embeddings.position_embedding.weight"].shape[0]),
        activation=activation, projection_dim=0 if proj is None else int(proj.shape[0]))


def _verified_clip(flat: dict, activation: str, prefix: str):
    cfg = _clip_config(flat, activation)
    _drop_extras(flat, verify_tree_names(set(flat), "clip", cfg, prefix.rstrip(".")),
                 prefix.rstrip("."))
    return flat, cfg


def convert_clip_hf(sd: dict, prefix: str, activation: str = "quick_gelu"):
    """prefix up to and including 'text_model.' → (state dict, config);
    HF's text_projection is already the (out, in) linear the port holds.
    activation: "gelu" for an HF-layout bigG (SD3's bundled one)."""
    flat = {k: v for k, v in _component(sd, prefix).items()
            if k != "embeddings.position_ids"}
    return _verified_clip(flat, activation, prefix)


# --------------------------------------------------------------------------
# CLIP (open_clip layout — SD2 / SDXL bigG)
# --------------------------------------------------------------------------

_OPENCLIP_RENAMES = (("attn.out_proj.", "self_attn.out_proj."), ("ln_1.", "layer_norm1."),
                     ("ln_2.", "layer_norm2."), ("mlp.c_fc.", "mlp.fc1."),
                     ("mlp.c_proj.", "mlp.fc2."))


def convert_clip_openclip(sd: dict, prefix: str):
    """prefix up to and including 'model.' (the open_clip text tower) →
    (state dict in the HF names, config)."""
    flat = {}
    for sub, v in _component(sd, prefix).items():
        if sub == "text_projection":          # applied as x @ W: (in, out)
            flat["text_projection.weight"] = v.t()
        elif sub == "token_embedding.weight":
            flat["embeddings.token_embedding.weight"] = v
        elif sub == "positional_embedding":
            flat["embeddings.position_embedding.weight"] = v
        elif sub.startswith("ln_final."):
            flat["final_layer_norm." + sub[len("ln_final."):]] = v
        m = re.match(r"transformer\.resblocks\.(\d+)\.(.+)", sub)
        if not m:
            continue                          # logit_scale, visual.*
        base, rest = f"encoder.layers.{m.group(1)}.", m.group(2)
        if rest in ("attn.in_proj_weight", "attn.in_proj_bias"):
            kind = rest[len("attn.in_proj_"):]
            for name, part in zip("qkv", v.chunk(3, dim=0)):
                flat[base + f"self_attn.{name}_proj.{kind}"] = part
            continue
        for old, new in _OPENCLIP_RENAMES:
            if rest.startswith(old):
                flat[base + new + rest[len(old):]] = v
    return _verified_clip(flat, "gelu", prefix)


def openclip_state_dict(hf: dict) -> dict:
    """The inverse of :func:`convert_clip_openclip`: a text encoder's HF
    names → the open_clip text tower's keys (q, k, v fused into in_proj,
    text_projection as open_clip's (in, out))."""
    out = {}
    for name, v in hf.items():
        if name == "text_projection.weight":
            out["text_projection"] = v.t().contiguous()
        elif name == "embeddings.token_embedding.weight":
            out["token_embedding.weight"] = v
        elif name == "embeddings.position_embedding.weight":
            out["positional_embedding"] = v
        elif name.startswith("final_layer_norm."):
            out["ln_final." + name[len("final_layer_norm."):]] = v
        m = re.match(r"encoder\.layers\.(\d+)\.(.+)", name)
        if not m:
            continue
        base, rest = f"transformer.resblocks.{m.group(1)}.", m.group(2)
        p = re.match(r"self_attn\.q_proj\.(weight|bias)", rest)
        if p:
            parts = [hf[f"encoder.layers.{m.group(1)}.self_attn.{n}_proj.{p.group(1)}"]
                     for n in "qkv"]
            out[base + f"attn.in_proj_{p.group(1)}"] = torch.cat(parts)
            continue
        for old, new in _OPENCLIP_RENAMES:
            if rest.startswith(new):
                out[base + old + rest[len(new):]] = v
    return out


# --------------------------------------------------------------------------
# ControlNet (convert.py:277-364)
# --------------------------------------------------------------------------

_DIFFUSERS_RESNET = {
    "norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
    "norm2": "out_layers.0", "conv2": "out_layers.3", "conv_shortcut": "skip_connection",
}


def _controlnet_diffusers_to_ldm(sd: dict) -> dict:
    """A diffusers ControlNet state dict in the cldm names (input_blocks,
    zero_convs, ...); the attention subtrees keep their names, which are
    ldm's already."""
    n_res = len({k.split(".")[3] for k in sd if k.startswith("down_blocks.0.resnets.")})
    out = {}
    for k, v in sd.items():
        m = re.match(r"down_blocks\.(\d+)\.resnets\.(\d+)\.(.+)", k)
        if m:
            i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            name, _, tail = rest.rpartition(".")
            out[f"input_blocks.{1 + i * (n_res + 1) + j}.0.{_DIFFUSERS_RESNET[name]}.{tail}"] = v
            continue
        m = re.match(r"down_blocks\.(\d+)\.attentions\.(\d+)\.(.+)", k)
        if m:
            i, j, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            out[f"input_blocks.{1 + i * (n_res + 1) + j}.1.{rest}"] = v
            continue
        m = re.match(r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.(.+)", k)
        if m:
            out[f"input_blocks.{1 + int(m.group(1)) * (n_res + 1) + n_res}.0.op."
                f"{m.group(2)}"] = v
            continue
        m = re.match(r"mid_block\.resnets\.(\d+)\.(.+)", k)
        if m:
            name, _, tail = m.group(2).rpartition(".")
            out[f"middle_block.{2 * int(m.group(1))}.{_DIFFUSERS_RESNET[name]}.{tail}"] = v
            continue
        m = re.match(r"mid_block\.attentions\.0\.(.+)", k)
        if m:
            out[f"middle_block.1.{m.group(1)}"] = v
            continue
        m = re.match(r"controlnet_down_blocks\.(\d+)\.(.+)", k)
        if m:
            out[f"zero_convs.{m.group(1)}.0.{m.group(2)}"] = v
            continue
        tail = k.rsplit(".", 1)[-1]
        if k.startswith("controlnet_mid_block."):
            out["middle_block_out.0." + tail] = v
        elif k.startswith("controlnet_cond_embedding.conv_in."):
            out["input_hint_block.0." + tail] = v
        elif k.startswith("controlnet_cond_embedding.conv_out."):
            out["input_hint_block.14." + tail] = v
        elif k.startswith("controlnet_cond_embedding.blocks."):
            parts = k.split(".")
            out[f"input_hint_block.{2 + 2 * int(parts[2])}.{parts[3]}"] = v
        elif k.startswith("conv_in."):
            out["input_blocks.0.0." + tail] = v
        elif k.startswith("time_embedding.linear_1."):
            out["time_embed.0." + tail] = v
        elif k.startswith("time_embedding.linear_2."):
            out["time_embed.2." + tail] = v
        elif k.startswith("add_embedding.linear_1."):
            out["label_emb.0.0." + tail] = v
        elif k.startswith("add_embedding.linear_2."):
            out["label_emb.0.2." + tail] = v
    return out


def convert_controlnet(sd: dict, verify: bool = True):
    """A ControlNet state dict (official ``control_model.*``, bare cldm, or
    diffusers) → (the tower's state dict, UNetConfig, hint channels)."""
    if any(k.startswith(("controlnet_down_blocks.", "controlnet_cond_embedding.")) for k in sd):
        sd, prefix = _controlnet_diffusers_to_ldm(sd), ""
    else:
        prefix = "control_model." if any(k.startswith("control_model.") for k in sd) else ""
    cfg = derive_unet_config(sd, prefix)
    hint_channels = int(sd[prefix + "input_hint_block.0.weight"].shape[1])
    flat = _component(sd, prefix)
    if verify:
        what = prefix.rstrip(".") or "controlnet"
        _drop_extras(flat, verify_tree_names(set(flat), "controlnet", cfg, what), what)
    return flat, cfg, hint_channels


# --------------------------------------------------------------------------
# MiDaS DPT-hybrid and ControlNetHED (midas.py:285-326, hed.py:61-78)
# --------------------------------------------------------------------------

def convert_dpt(sd: dict, prefix: str = "depth_model.model.", verify: bool = True):
    """A torch ``DPTDepthModel`` state dict (``pretrained.model.*`` /
    ``scratch.*`` under `prefix`: SD2-depth's ``depth_model.model.``, or
    none in the annotator's file) → (the tower's state dict, DPTConfig).
    The config comes from the shapes, the hooks and head count as JAX
    derives them (blocks 8 and 11 of a 12-layer ViT, 64-wide heads)."""
    from sdwebui_tpu_torch.models.midas import DPTConfig

    flat = _component(sd, prefix)
    g = lambda k: flat["pretrained.model." + k]   # noqa: E731
    backbone = "patch_embed.backbone."
    stages = sorted({int(k.split(".")[5]) for k in flat
                     if k.startswith("pretrained.model." + backbone + "stages.")})
    blocks = [sorted({int(k.split(".")[7]) for k in flat if k.startswith(
        f"pretrained.model.{backbone}stages.{s}.blocks.")}) for s in stages]
    vit_width = int(g("cls_token").numel())
    side = int(round((g("pos_embed").numel() // vit_width - 1) ** 0.5))
    vit_layers = 1 + max(int(k.split(".")[3]) for k in flat
                         if k.startswith("pretrained.model.blocks."))
    cfg = DPTConfig(
        image_size=side * 16,
        stem_width=int(g(backbone + "stem.conv.weight").shape[0]),
        stage_blocks=tuple(len(b) for b in blocks),
        stage_widths=tuple(int(g(f"{backbone}stages.{s}.blocks.0.conv3.weight").shape[0])
                           for s in stages),
        vit_width=vit_width, vit_layers=vit_layers, vit_heads=max(vit_width // 64, 1),
        hooks=(8, 11) if vit_layers >= 12 else (max(vit_layers - 2, 0), vit_layers - 1),
        features=int(flat["scratch.layer1_rn.weight"].shape[0]),
        head_width=int(flat["scratch.output_conv.2.weight"].shape[0]),
        stem_norm="pretrained.model." + backbone + "stem.norm.weight" in flat,
        backbone_norm="pretrained.model." + backbone + "norm.weight" in flat)
    if verify:
        what = prefix.rstrip(".") or "dpt"
        _drop_extras(flat, verify_tree_names(set(flat), "dpt", cfg, what), what)
    return flat, cfg


def convert_hed(sd: dict, verify: bool = True):
    """A ControlNetHED state dict (keys bare or under ``netNetwork.``) →
    (the net's state dict, its five widths)."""
    flat = {k.removeprefix("netNetwork."): v for k, v in sd.items()}
    flat["norm"] = flat["norm"].reshape(1, 3, 1, 1)
    widths = tuple(int(flat[f"block{i}.projection.weight"].shape[1]) for i in range(1, 6))
    if verify:
        _drop_extras(flat, verify_tree_names(set(flat), "hed", widths, "hed"), "hed")
    return flat, widths


# --------------------------------------------------------------------------
# SD3 MMDiT
# --------------------------------------------------------------------------

def has_pre_only_proj(flat: dict, depth: int) -> bool:
    """Whether the last block's pre-only context side carries an
    ``attn.proj`` (the JAX package's random trees do, published files not)."""
    return f"joint_blocks.{depth - 1}.context_block.attn.proj.weight" in flat


def convert_mmdit(sd: dict, prefix: str = "model.diffusion_model.", verify: bool = True):
    """→ (the MMDiT's state dict, MMDiTConfig) (convert.py:544-560): depth
    from the joint blocks, the context and pooled widths, the position
    table's side and the rms q/k norm read off the shapes; no layout
    transposes.  The names are checked against ``MMDiT(cfg)``'s."""
    from sdwebui_tpu_torch.models.mmdit import MMDiTConfig

    flat = _component(sd, prefix)
    depth = 1 + max(int(k.split(".")[1]) for k in flat if k.startswith("joint_blocks."))
    y = flat.get("y_embedder.mlp.0.weight")
    cfg = MMDiTConfig(
        in_channels=int(flat["x_embedder.proj.weight"].shape[1]), depth=depth,
        context_dim=int(flat["context_embedder.weight"].shape[1]),
        pooled_dim=2048 if y is None else int(y.shape[1]),
        pos_embed_max_size=int(round(flat["pos_embed"].shape[-2] ** 0.5)),
        qk_norm=any(k.endswith("ln_q.weight") for k in flat))
    if verify:
        _drop_extras(flat, verify_tree_names(set(flat), "mmdit", cfg, prefix.rstrip("."),
                                             has_pre_only_proj(flat, depth)),
                     prefix.rstrip("."))
    return flat, cfg
