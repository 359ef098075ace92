"""CodeFormer face restorer, NCHW.

Port of ``sdwebui_tpu/models/codeformer.py`` (the reference calls
``net(face, weight=w, adain=True)``): a VQGAN encoder (GroupNorm-swish
ResBlocks, single-head AttnBlocks at 16², stride-2 downsamples) whose
16² feature feeds a 9-layer pre-norm transformer (``ft_layers``: MHA with a
learned position embedding on q and k, a GELU MLP) that predicts an index
into a 1024-entry codebook for each of the 256 positions; the code's
vectors, AdaIN-matched to the encoder feature (unbiased variance), go
through the VQGAN generator, whose features at 32²–256² are fused with
the encoder's through SFT blocks weighted by ``w`` (0: the codebook prior
alone, 1: fidelity to the input; the fusion runs only for w > 0).
Parameter names are the checkpoint's ``params_ema`` keys; the flat
``blocks.{i}`` lists follow ``encoder_plan`` / ``generator_plan``.

The LayerNorms (the transformer's 18 and ``idx_pred_layer``'s) are
``models/layers.LayerNorm``: on the card they run the B5 kernel in f32, 19
launches a face.  The attentions go through ``ops/attention.attention``;
at 256 positions its Skv >= 1024 rule takes the plain path, as JAX's
``_use_flash`` does.  :meth:`CodeFormer.encode` returns the code logits
too, so a caller can hold them against another computation.  f32
throughout; TF32 stays off (``utils/devices``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import (Conv2d, Embedding, LayerNorm, Linear, assign_f32,
                                             reset_random)
from sdwebui_tpu_torch.ops.attention import attention
from sdwebui_tpu_torch.utils.devices import get_device


@dataclasses.dataclass(frozen=True)
class CodeFormerConfig:
    img_size: int = 512
    nf: int = 64
    ch_mult: tuple = (1, 2, 2, 4, 4, 8)
    res_blocks: int = 2
    attn_resolutions: tuple = (16,)
    emb_dim: int = 256
    codebook_size: int = 1024
    dim_embd: int = 512
    n_head: int = 8
    n_layers: int = 9
    connect_list: tuple = ("32", "64", "128", "256")

    @property
    def latent_size(self) -> int:
        return self.img_size // 2 ** (len(self.ch_mult) - 1)


# --------------------------------------------------------------------------
# plans: the checkpoint's flat blocks.{i} lists (codeformer.py:62-118)
# --------------------------------------------------------------------------

def encoder_plan(cfg: CodeFormerConfig):
    """[(kind, cin, cout)], fuse {resolution: block index}: the feature is
    taken after the last ResBlock of each level."""
    plan = [("conv", 3, cfg.nf)]
    fuse = {}
    mults = (1,) + tuple(cfg.ch_mult)
    res = cfg.img_size
    for i in range(len(cfg.ch_mult)):
        cin, cout = cfg.nf * mults[i], cfg.nf * cfg.ch_mult[i]
        for _ in range(cfg.res_blocks):
            plan.append(("res", cin, cout))
            cin = cout
            fuse[res] = len(plan) - 1
            if res in cfg.attn_resolutions:
                plan.append(("attn", cin, cin))
        if i != len(cfg.ch_mult) - 1:
            plan.append(("down", cin, cin))
            res //= 2
    plan += [("res", cin, cin), ("attn", cin, cin), ("res", cin, cin),
             ("norm", cin, cin), ("conv", cin, cfg.emb_dim)]
    return plan, fuse


def generator_plan(cfg: CodeFormerConfig):
    """[(kind, cin, cout)], fuse {resolution: block index}: the first level
    fuses after its last ResBlock, the later ones after their first."""
    cin = cfg.nf * cfg.ch_mult[-1]
    res = cfg.latent_size
    plan = [("conv", cfg.emb_dim, cin), ("res", cin, cin), ("attn", cin, cin), ("res", cin, cin)]
    fuse = {}
    for i in reversed(range(len(cfg.ch_mult))):
        cout = cfg.nf * cfg.ch_mult[i]
        first_of_level = None
        for _ in range(cfg.res_blocks):
            plan.append(("res", cin, cout))
            cin = cout
            if first_of_level is None:
                first_of_level = len(plan) - 1
            last_of_level = len(plan) - 1
            if res in cfg.attn_resolutions:
                plan.append(("attn", cin, cin))
        fuse[res] = last_of_level if i == len(cfg.ch_mult) - 1 else first_of_level
        if i > 0:
            plan.append(("up", cin, cin))
            res *= 2
    plan += [("norm", cin, cin), ("conv", cin, 3)]
    return plan, fuse


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

class GroupNorm(nn.Module):
    """GroupNorm(min(32, C)), eps 1e-6, two-pass f32 statistics (``_gn``)."""

    def __init__(self, c: int, *, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, device=device, dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(c, device=device, dtype=dtype),
                                 requires_grad=False)

    def forward(self, x, swish: bool = False):
        out = F.group_norm(x.float(), min(32, x.shape[1]), self.weight.float(),
                           self.bias.float(), eps=1e-6).to(x.dtype)
        return F.silu(out) if swish else out

    @torch.no_grad()
    def reset_random(self, gen):
        self.weight.fill_(1.0)
        self.bias.zero_()


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(cin, **kw), Conv2d(cin, cout, 3, **kw)
        self.norm2, self.conv2 = GroupNorm(cout, **kw), Conv2d(cout, cout, 3, **kw)
        self.conv_out = Conv2d(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x):
        h = self.conv1(self.norm1(x, swish=True))
        h = self.conv2(self.norm2(h, swish=True))
        return (x if self.conv_out is None else self.conv_out(x)) + h


class AttnBlock(nn.Module):
    """Single-head attention over the positions, 1x1-conv projections."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.norm = GroupNorm(c, **kw)
        self.q, self.k, self.v, self.proj_out = (Conv2d(c, c, 1, **kw) for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.norm(x)

        def tokens(conv):
            return conv(t).reshape(b, c, h * w).transpose(1, 2)

        out = attention(tokens(self.q), tokens(self.k), tokens(self.v), scale=c ** -0.5)
        return x + self.proj_out(out.transpose(1, 2).reshape(b, c, h, w))


class _Resample(nn.Module):
    """``Downsample`` (pad right and bottom by 1, 3x3 stride 2, no padding)
    or ``Upsample`` (nearest 2x, 3x3)."""

    def __init__(self, c: int, down: bool, **kw):
        super().__init__()
        self.conv = Conv2d(c, c, 3, 2, padding=0, **kw) if down else Conv2d(c, c, 3, **kw)
        self.down = down

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _blocks(plan, **kw) -> nn.ModuleList:
    out = nn.ModuleList()
    for kind, cin, cout in plan:
        if kind == "conv":
            out.append(Conv2d(cin, cout, 3, **kw))
        elif kind == "res":
            out.append(ResBlock(cin, cout, **kw))
        elif kind == "attn":
            out.append(AttnBlock(cin, **kw))
        elif kind in ("down", "up"):
            out.append(_Resample(cin, kind == "down", **kw))
        else:                                   # "norm": GroupNorm + swish
            out.append(GroupNorm(cin, **kw))
    return out


def _walk(blocks: nn.ModuleList, x, fuse: dict, fuse_fn):
    for i, block in enumerate(blocks):
        x = block(x, swish=True) if isinstance(block, GroupNorm) else block(x)
        if i in fuse:
            x = fuse_fn(x)
    return x


class SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters: a fused in_proj and out_proj."""

    def __init__(self, d: int, n_head: int, **kw):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty((3 * d, d), **kw), requires_grad=False)
        self.in_proj_bias = nn.Parameter(torch.empty((3 * d,), **kw), requires_grad=False)
        self.out_proj = Linear(d, d, **kw)
        self.n_head = n_head

    def forward(self, qk, v):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        d = qk.shape[-1]
        out = attention(F.linear(qk, wq, bq), F.linear(qk, wk, bk), F.linear(v, wv, bv),
                        num_heads=self.n_head, scale=1.0 / math.sqrt(d // self.n_head))
        return self.out_proj(out)

    @torch.no_grad()
    def reset_random(self, gen):
        d = self.in_proj_weight.shape[1]
        self.in_proj_weight.copy_(torch.randn(self.in_proj_weight.shape, generator=gen,
                                              device=gen.device) / math.sqrt(d))
        self.in_proj_bias.zero_()


class TransformerLayer(nn.Module):
    """``_ft_layer``: pre-norm self-attention (position embedding on q, k)
    and a GELU MLP, each residual."""

    def __init__(self, d: int, n_head: int, **kw):
        super().__init__()
        self.self_attn = SelfAttention(d, n_head, **kw)
        self.norm1, self.norm2 = LayerNorm(d, **kw), LayerNorm(d, **kw)
        self.linear1, self.linear2 = Linear(d, 2 * d, **kw), Linear(2 * d, d, **kw)

    def forward(self, x, pos):
        t = self.norm1(x)
        x = x + self.self_attn(t + pos, t)
        return x + self.linear2(F.gelu(self.linear1(self.norm2(x))))


class FuseSFT(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.encode_enc = ResBlock(2 * c, c, **kw)
        self.scale = nn.ModuleDict({"0": Conv2d(c, c, 3, **kw), "2": Conv2d(c, c, 3, **kw)})
        self.shift = nn.ModuleDict({"0": Conv2d(c, c, 3, **kw), "2": Conv2d(c, c, 3, **kw)})

    def forward(self, enc_feat, dec_feat, w: float):
        enc = self.encode_enc(torch.cat([enc_feat, dec_feat], dim=1))
        scale = self.scale["2"](F.leaky_relu(self.scale["0"](enc), 0.2))
        shift = self.shift["2"](F.leaky_relu(self.shift["0"](enc), 0.2))
        return dec_feat + w * (dec_feat * scale + shift)


def adaptive_instance_norm(content, style, eps: float = 1e-5):
    """Adaptive instance normalisation over the spatial dims, unbiased
    variances (calc_mean_std, ``_adain``)."""
    c, s = content.float(), style.float()
    cm, sm = c.mean(dim=(2, 3), keepdim=True), s.mean(dim=(2, 3), keepdim=True)
    cs = torch.sqrt(c.var(dim=(2, 3), keepdim=True, unbiased=True) + eps)
    ss = torch.sqrt(s.var(dim=(2, 3), keepdim=True, unbiased=True) + eps)
    return ((c - cm) / cs * ss + sm).to(content.dtype)


class CodeFormer(nn.Module):
    def __init__(self, cfg: CodeFormerConfig = CodeFormerConfig(), *, device="cpu",
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        e_plan, e_fuse = encoder_plan(cfg)
        g_plan, g_fuse = generator_plan(cfg)
        self._e_fuse = {i: r for r, i in e_fuse.items()}
        self._g_fuse = {i: r for r, i in g_fuse.items()}
        self.encoder, self.generator = nn.Module(), nn.Module()
        self.encoder.blocks = _blocks(e_plan, **kw)
        self.generator.blocks = _blocks(g_plan, **kw)
        self.quantize = nn.Module()
        self.quantize.embedding = Embedding(cfg.codebook_size, cfg.emb_dim, init_scale=1.0, **kw)
        d = cfg.dim_embd
        self.position_emb = nn.Parameter(torch.empty((cfg.latent_size ** 2, d), **kw),
                                         requires_grad=False)
        self.feat_emb = Linear(cfg.emb_dim, d, **kw)
        self.ft_layers = nn.ModuleList(TransformerLayer(d, cfg.n_head, **kw)
                                       for _ in range(cfg.n_layers))
        self.idx_pred_layer = nn.ModuleDict({
            "0": LayerNorm(d, **kw), "1": Linear(d, cfg.codebook_size, bias=False, **kw)})
        res_ch = {}
        res = cfg.latent_size
        for i in reversed(range(len(cfg.ch_mult))):
            res_ch[res] = cfg.nf * cfg.ch_mult[i]
            res *= 2
        self.fuse_convs_dict = nn.ModuleDict({r: FuseSFT(res_ch[int(r)], **kw)
                                              for r in cfg.connect_list})
        self._connect = {int(r) for r in cfg.connect_list}

    def encode(self, x):
        """x (B, 3, S, S) in [-1, 1] → (lq feature (B, emb, h, w), the
        encoder's features by resolution, code logits (B, h·w, codebook))."""
        enc_feats = {}

        def capture(feat):
            if feat.shape[2] in self._connect:
                enc_feats[feat.shape[2]] = feat
            return feat

        lq = _walk(self.encoder.blocks, x.float(), self._e_fuse, capture)
        b, c, h, w = lq.shape
        q = self.feat_emb(lq.reshape(b, c, h * w).transpose(1, 2))
        pos = self.position_emb[None]
        for layer in self.ft_layers:
            q = layer(q, pos)
        logits = self.idx_pred_layer["1"](self.idx_pred_layer["0"](q))
        return lq, enc_feats, logits

    def decode(self, lq, enc_feats: dict, logits, w: float = 0.5, adain: bool = True):
        """The codes the logits pick (argmax), AdaIN-matched to lq when
        adain, through the generator with the SFT fusion at weight w."""
        b, c, h, wd = lq.shape
        code = self.quantize.embedding.weight[logits.argmax(dim=-1)]      # (B, hw, emb)
        quant = code.transpose(1, 2).reshape(b, c, h, wd).to(lq.dtype)
        if adain:
            quant = adaptive_instance_norm(quant, lq)

        def fuse(feat):
            res = feat.shape[2]
            if res in self._connect and res in enc_feats and w > 0:
                return self.fuse_convs_dict[str(res)](enc_feats[res], feat, w)
            return feat

        return _walk(self.generator.blocks, quant, self._g_fuse, fuse)

    def forward(self, x, w: float = 0.5, adain: bool = True):
        """x (B, 3, S, S) in [-1, 1] → restored (B, 3, S, S)."""
        return self.decode(*self.encode(x), w=w, adain=adain)

    @torch.no_grad()
    def reset_random(self, gen: torch.Generator) -> "CodeFormer":
        """Seeded weights: the layers' distributions, codebook N(0, 1),
        position embedding N(0, 0.02²)."""
        reset_random(self, gen)
        for m in self.modules():
            if isinstance(m, (GroupNorm, SelfAttention)):
                m.reset_random(gen)
        self.position_emb.copy_(torch.randn(self.position_emb.shape, generator=gen,
                                            device=gen.device) * 0.02)
        return self


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

def config_from_state_dict(sd: dict) -> CodeFormerConfig:
    """``convert_codeformer``'s reading (codeformer.py:315-345): widths from
    the tensors, the rest the published config's."""
    n_pos, dim = sd["position_emb"].shape
    codebook, emb = sd["quantize.embedding.weight"].shape
    connect = tuple(sorted({k.split(".")[1] for k in sd if k.startswith("fuse_convs_dict.")},
                           key=int))
    return CodeFormerConfig(
        img_size=int(np.sqrt(n_pos)) * 2 ** 5 if n_pos == 256 else 512,
        nf=int(sd["encoder.blocks.0.weight"].shape[0]), emb_dim=int(emb),
        codebook_size=int(codebook), dim_embd=int(dim),
        n_layers=len({k.split(".")[1] for k in sd if k.startswith("ft_layers.")}),
        connect_list=connect or ("32", "64", "128", "256"))


def codeformer_from_state_dict(sd: dict, device="cuda",
                               cfg: CodeFormerConfig | None = None) -> CodeFormer:
    """A CodeFormer state dict (``params_ema`` prefixed or not) → the net on
    `device`, in f32; cfg None reads it as JAX does."""
    if any(k.startswith("params_ema.") for k in sd):
        sd = {k[len("params_ema."):]: v for k, v in sd.items() if k.startswith("params_ema.")}
    net = CodeFormer(cfg or config_from_state_dict(sd), device="meta")
    return assign_f32(net, sd, get_device(device))


def codeformer_from_jax(tree: dict, cfg: CodeFormerConfig, device="cpu") -> CodeFormer:
    """The JAX package's tree (``convert_codeformer``'s layout: convs HWIO,
    the encoder's and generator's blocks without their ``blocks`` level)."""
    from sdwebui_tpu_torch.utils.pytree import flatten

    sd = {}
    for k, v in flatten(tree).items():
        t = torch.from_numpy(np.array(v, np.float32))
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        if k.startswith(("encoder.", "generator.")):
            side, rest = k.split(".", 1)
            k = f"{side}.blocks.{rest}"
        sd[k] = t
    return codeformer_from_state_dict(sd, device, cfg)


def create_random_codeformer(seed: int = 0, device="cuda",
                             cfg: CodeFormerConfig = CodeFormerConfig()) -> CodeFormer:
    """A seeded random CodeFormer at `cfg` (default: the published v0.1.0
    widths), f32."""
    device = get_device(device)
    net = CodeFormer(cfg, device=device)
    return net.reset_random(torch.Generator(device=device).manual_seed(seed)).eval()
