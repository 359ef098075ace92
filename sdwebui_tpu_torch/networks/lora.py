"""LoRA / LyCORIS weight deltas on the port's modules.

Port of ``sdwebui_tpu/networks/lora.py``.  The port's parameters are
already in the ldm/torch layout the network files use (conv OIHW, linear
(out, in)), so JAX's layout round trips have no counterpart here: a
delta is computed in fp32 on the weight's device, every delta of one
weight is added to it in fp32, and the sum is cast once to the weight's
dtype (``apply_loras``).

Algebras (reference ``extensions-builtin/Lora/network_*.py``): lora
(linear and conv), hada (LoHa), lokr (with a Tucker ``t2``), full/diff,
ia3, norm, glora and oft, each optionally with DoRA's weight
decomposition (``dora_scale``).

Key naming: kohya/compvis ``lora_unet_<path_with_underscores>`` and
``lora_te_text_model_...``; the diffusers-style SDXL UNet names are
translated; the module's own parameter names resolve the underscore
ambiguity and an up block's upsampler slot (JAX's map fixes SD1's slots,
``sdwebui_tpu/networks/lora.py:57-58``, which misses SDXL's upsampler in
output block 2; that is not carried over).
"""

from __future__ import annotations

import re

import torch

# --------------------------------------------------------------------------
# key resolution (lora.py:32-92)
# --------------------------------------------------------------------------


def build_path_lookup(names) -> dict:
    """underscore-joined module path → dotted module path, for every module
    that owns a ``weight`` among the parameter `names`."""
    out = {}
    for name in names:
        if name.endswith(".weight"):
            module = name[: -len(".weight")]
            out[module.replace(".", "_")] = module
    return out


_DIFFUSERS_UNET = [
    (re.compile(r"^down_blocks_(\d+)_attentions_(\d+)_"),
     lambda m: f"input_blocks_{3 * int(m.group(1)) + int(m.group(2)) + 1}_1_"),
    (re.compile(r"^down_blocks_(\d+)_resnets_(\d+)_"),
     lambda m: f"input_blocks_{3 * int(m.group(1)) + int(m.group(2)) + 1}_0_"),
    (re.compile(r"^mid_block_attentions_0_"), lambda m: "middle_block_1_"),
    (re.compile(r"^mid_block_resnets_(\d+)_"),
     lambda m: f"middle_block_{2 * int(m.group(1))}_"),
    (re.compile(r"^up_blocks_(\d+)_attentions_(\d+)_"),
     lambda m: f"output_blocks_{3 * int(m.group(1)) + int(m.group(2))}_1_"),
    (re.compile(r"^up_blocks_(\d+)_resnets_(\d+)_"),
     lambda m: f"output_blocks_{3 * int(m.group(1)) + int(m.group(2))}_0_"),
    (re.compile(r"^down_blocks_(\d+)_downsamplers_0_conv"),
     lambda m: f"input_blocks_{3 * (int(m.group(1)) + 1)}_0_op"),
    # the upsampler's slot follows the model's own output block (_upsampler)
    (re.compile(r"^up_blocks_(\d+)_upsamplers_0_conv"), None),
]

_DIFFUSERS_RENAMES = [
    ("_time_emb_proj", "_emb_layers_1"), ("_conv1", "_in_layers_2"),
    ("_conv2", "_out_layers_3"), ("_conv_shortcut", "_skip_connection"),
]


def _upsampler(m, lookup: dict) -> str:
    """A diffusers up block's upsampler conv: slot 2 of the block's last
    output block when that block holds a transformer (slot 1), else slot 1
    (SD1's up_blocks_0 has none; SDXL's has one)."""
    block = 3 * int(m.group(1)) + 2
    slot = 2 if f"output_blocks_{block}_1_proj_in" in lookup else 1
    return f"output_blocks_{block}_{slot}_conv"


def normalize_unet_key(key: str, lookup: dict) -> str:
    """A diffusers UNet name → the ldm one in `lookup`'s model (kohya and
    compvis names pass through)."""
    for pat, repl in _DIFFUSERS_UNET:
        m = pat.match(key)
        if m:
            key = pat.sub(repl(m) if repl else _upsampler(m, lookup), key, count=1)
            break
    for a, b in _DIFFUSERS_RENAMES:
        key = key.replace(a, b)
    return key


def resolve_module(key: str, lookup: dict) -> str | None:
    """A network file's module name (underscores) → the dotted module path."""
    if key in lookup:
        return lookup[key]
    # kohya text-encoder keys carry the HF module root the port's names omit
    if key.startswith("text_model_") and key[len("text_model_"):] in lookup:
        return lookup[key[len("text_model_"):]]
    return lookup.get(normalize_unet_key(key, lookup))


def group_lora_keys(lora_sd: dict, prefix: str) -> dict:
    """{module_name: {suffix: tensor}} for the keys starting with `prefix`
    (lora_unet_ / lora_te_ / lora_te1_ / lora_te2_)."""
    groups: dict = {}
    for k, v in lora_sd.items():
        if not k.startswith(prefix):
            continue
        rest = k[len(prefix):]
        if "." not in rest:
            continue
        module, suffix = rest.split(".", 1)
        groups.setdefault(module, {})[suffix] = v
    return groups


# --------------------------------------------------------------------------
# deltas (lora.py:98-209), all in fp32 on the weight's device
# --------------------------------------------------------------------------

def _to_2d(w):
    return w.reshape(w.shape[0], -1)


def compute_delta(mods: dict, weight: torch.Tensor, mult: float):
    """mods: suffix → tensor of one module.  Returns ("add", delta of the
    weight's shape), ("ia3", (vector, on_input, mult)), ("norm", (w, b,
    mult)), or None for an unknown algebra.  `weight` is the module's
    current weight (GLoRA and OFT read it)."""
    dev = weight.device

    def f32(name):
        return torch.as_tensor(mods[name]).to(dev, torch.float32)

    def alpha_scale(rank: int) -> float:
        alpha = float(mods["alpha"]) if "alpha" in mods else float(rank)
        return alpha / rank * mult

    shape = weight.shape
    if all(k in mods for k in ("a1.weight", "a2.weight", "b1.weight", "b2.weight")):
        # GLoRA: ΔW = b2·b1 + (W·a2)·a1
        w = weight.float().reshape(shape[0], -1)
        delta = f32("b2.weight") @ f32("b1.weight") + (w @ f32("a2.weight")) @ f32("a1.weight")
        return "add", (delta * mult).reshape(shape)

    if "oft_blocks" in mods:
        # OFT / COFT (kohya blocks): per output block a Cayley rotation
        # R = (I + Q)(I − Q)⁻¹ of the skew part Q
        blocks = f32("oft_blocks")                       # (k, b, b)
        num_blocks, block_size = blocks.shape[0], blocks.shape[-1]
        q = blocks - blocks.transpose(-1, -2)
        if "alpha" in mods and float(mods["alpha"]) != 0:
            constraint = float(mods["alpha"]) * shape[0]
            norm_q = torch.linalg.norm(q)
            q = q * (torch.clamp(norm_q, max=constraint) + 1e-8) / (norm_q + 1e-8)
        eye = torch.eye(block_size, dtype=torch.float32, device=dev)
        r = torch.stack([(eye + qk) @ torch.linalg.inv(eye - qk) for qk in q])
        w = weight.float()
        merged = w.reshape(num_blocks, block_size, -1)
        rotated = torch.einsum("knm,kna->kma", r, merged)
        return "add", ((rotated.reshape(shape) - w) * mult)

    if "lora_up.weight" in mods and "lora_down.weight" in mods:
        up, down = f32("lora_up.weight"), f32("lora_down.weight")
        scale = alpha_scale(down.shape[0])
        if down.dim() == 4 and tuple(down.shape[2:]) != (1, 1):
            # conv lora: up (O, r, 1, 1) · down (r, I, kh, kw)
            delta = torch.einsum("or,rikl->oikl", _to_2d(up), down) * scale
        else:
            delta = (_to_2d(up) @ _to_2d(down)) * scale
        return "add", delta.reshape(shape)

    if "hada_w1_a" in mods:
        scale = alpha_scale(mods["hada_w1_b"].shape[0])
        delta = (_to_2d(f32("hada_w1_a")) @ _to_2d(f32("hada_w1_b"))) \
            * (_to_2d(f32("hada_w2_a")) @ _to_2d(f32("hada_w2_b"))) * scale
        return "add", delta.reshape(shape)

    if "lokr_w1" in mods or "lokr_w1_a" in mods:
        w1 = f32("lokr_w1") if "lokr_w1" in mods else f32("lokr_w1_a") @ f32("lokr_w1_b")
        if "lokr_w2" in mods:
            w2 = f32("lokr_w2")
        elif "lokr_t2" in mods:
            w2 = torch.einsum("ijkl,ip,jq->pqkl", f32("lokr_t2"), f32("lokr_w2_a"),
                              f32("lokr_w2_b"))
        else:
            w2 = f32("lokr_w2_a") @ f32("lokr_w2_b")
        rank = mods["lokr_w1_b"].shape[0] if "lokr_w1_b" in mods else \
            (mods["lokr_w2_b"].shape[0] if "lokr_w2_b" in mods else w1.shape[1])
        delta = torch.kron(_to_2d(w1), _to_2d(w2)) * alpha_scale(int(rank))
        return "add", delta.reshape(shape)

    if "weight" in mods or "diff" in mods:       # full
        return "add", (f32("diff" if "diff" in mods else "weight") * mult).reshape(shape)

    if "on_input" in mods or "w" in mods:        # ia3
        on_input = bool(torch.as_tensor(mods.get("on_input", 0)).item())
        return "ia3", (f32("w").reshape(-1), on_input, mult)

    if "w_norm" in mods:                         # norm
        return "norm", (f32("w_norm"), f32("b_norm") if "b_norm" in mods else None, mult)
    return None


def apply_dora(delta, orig, dora_scale):
    """DoRA's weight decomposition: W + ΔW renormalised per output row to
    the learned magnitudes; returned as the equivalent additive delta."""
    merged = orig + delta
    norm = torch.linalg.norm(merged.reshape(merged.shape[0], -1), dim=1)
    norm = norm.reshape((-1,) + (1,) * (merged.dim() - 1))
    scale = torch.as_tensor(dora_scale).to(orig.device, torch.float32).reshape(norm.shape)
    return merged / norm * scale - orig


# --------------------------------------------------------------------------
# application (lora.py:251-344)
# --------------------------------------------------------------------------

def apply_loras(params: dict, loras: list, prefix: str = "lora_unet_", hp: dict | None = None):
    """params: a module's {name: tensor}; loras: [(lora state dict, mult)];
    hp: the high-precision copies of weights stored in fp8 (fp8 storage
    with opts.cache_fp16_weight), the base of their merges (lora.py:256).
    Returns ({name: new tensor} for every patched parameter, in the stored
    dtype, modules applied, unmatched module names).  The patched tensors
    are new; the given ones are not touched."""
    hp = hp or {}

    def base(name):
        w = params[name]
        return hp[name].to(w.device) if name in hp else w

    lookup = build_path_lookup(params)
    patches: dict = {}
    unmatched = []
    n_applied = 0
    for lora_sd, mult in loras:
        if mult == 0:
            continue
        for module, mods in group_lora_keys(lora_sd, prefix).items():
            path = resolve_module(module, lookup)
            if path is None:
                unmatched.append(module)
                continue
            w = base(path + ".weight")
            if "dora_scale" in mods:
                # the alpha-scaled delta decomposed against the merged
                # weight's row norms; the multiplier scales the result
                op = compute_delta(mods, w, 1.0)
                if op is not None and op[0] == "add":
                    op = ("add", apply_dora(op[1], w.float(), mods["dora_scale"]) * mult)
            else:
                op = compute_delta(mods, w, mult)
            if op is None:
                unmatched.append(module)
                continue
            patches.setdefault(path, []).append(op)
            n_applied += 1

    out = {}
    for path, ops in patches.items():
        w = params[path + ".weight"]
        wf = base(path + ".weight").float()
        for kind, payload in ops:
            if kind == "add":
                wf = wf + payload
            elif kind == "ia3":
                vec, on_input, mult = payload
                scale = 1.0 + (vec - 1.0) * mult
                # (out, in[, kh, kw]): the input axis is 1, the output axis 0
                view = (1, -1) if on_input else (-1, 1)
                wf = wf * scale.reshape(view + (1,) * (wf.dim() - 2))
            else:       # norm
                wn, bn, mult = payload
                wf = wf + wn * mult
                bkey = path + ".bias"
                if bn is not None and bkey in params:
                    base = out.get(bkey, params[bkey])
                    out[bkey] = (base.float() + bn * mult).to(w.dtype)
        fmt = torch.channels_last if wf.dim() == 4 else torch.contiguous_format
        out[path + ".weight"] = wf.to(w.dtype).contiguous(memory_format=fmt)
    return out, n_applied, unmatched
