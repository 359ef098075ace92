"""XLM-RoBERTa, AltDiffusion's text encoder, as an ``nn.Module``, and its
conditioner.

Port of ``sdwebui_tpu/models/xlmr.py``: BERT-style post-LN blocks,
position ids counted over the non-pad tokens and offset by the pad id
(transformers' create_position_ids_from_input_ids), and a linear
``transformation`` of the last hidden state to the UNet's context width
(AltDiffusion-m18: ``pre_LN`` + ``transformation_pre`` of the penultimate
one).  Parameter names are the checkpoint's ``cond_stage_model.*`` keys
with the prefix stripped.  The 77-token masked attention is plain torch,
as in JAX; the LayerNorms (eps 1e-5) go through ``ops.norms.layer_norm``
(B5 on CUDA).  :class:`AltConditioner` pads a prompt's SentencePiece ids
(``text/sentencepiece.make_xlmr_tokenizer``) to 77 with <s> … </s> and the
pad id; emphasis and chunking are not applied, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Embedding, LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class XLMRConfig:
    vocab_size: int = 250002
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    intermediate: int = 4096
    project_dim: int = 768
    # AltDiffusion-m18: project the penultimate hidden state through pre_LN
    # + transformation_pre
    pre_transformation: bool = False
    pad_token_id: int = 1
    eps: float = 1e-5


#: XLM-R large with AltDiffusion's 768-wide projection
XLMR_LARGE = XLMRConfig()
#: the position table of XLM-R large (514 = 512 + the pad offset + 1)
MAX_POSITIONS = 514


def _ln(c, eps, kw):
    return LayerNorm(c, eps, **kw)


class _Self(nn.Module):
    def __init__(self, c, kw):
        super().__init__()
        self.query, self.key, self.value = Linear(c, c, **kw), Linear(c, c, **kw), \
            Linear(c, c, **kw)


class _Out(nn.Module):
    def __init__(self, cin, cout, eps, kw):
        super().__init__()
        self.dense = Linear(cin, cout, **kw)
        self.LayerNorm = _ln(cout, eps, kw)


class _Attention(nn.Module):
    def __init__(self, cfg, kw):
        super().__init__()
        self.self = _Self(cfg.hidden, kw)
        self.output = _Out(cfg.hidden, cfg.hidden, cfg.eps, kw)


class _Intermediate(nn.Module):
    def __init__(self, cfg, kw):
        super().__init__()
        self.dense = Linear(cfg.hidden, cfg.intermediate, **kw)


class _Layer(nn.Module):
    def __init__(self, cfg: XLMRConfig, kw):
        super().__init__()
        self.attention = _Attention(cfg, kw)
        self.intermediate = _Intermediate(cfg, kw)
        self.output = _Out(cfg.intermediate, cfg.hidden, cfg.eps, kw)

    def forward(self, x, heads, mask_bias):
        s = self.attention.self
        b, n, hd = x.shape
        d = hd // heads

        def split(t):
            return t.reshape(b, n, heads, d).transpose(1, 2)

        q, k, v = split(s.query(x)), split(s.key(x)), split(s.value(x))
        scores = torch.matmul(q * d ** -0.5, k.transpose(-1, -2)) + mask_bias
        p = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(b, n, hd)
        out = self.attention.output
        x = out.LayerNorm(x + out.dense(o))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class _Embeddings(nn.Module):
    def __init__(self, cfg: XLMRConfig, positions: int, kw):
        super().__init__()
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden, 0.02, **kw)
        self.position_embeddings = Embedding(positions, cfg.hidden, 0.02, **kw)
        self.token_type_embeddings = Embedding(1, cfg.hidden, 0.02, **kw)
        self.LayerNorm = _ln(cfg.hidden, cfg.eps, kw)


class XLMRModel(nn.Module):
    """forward(ids (B, S) int) → the projected context (B, S, project_dim)."""

    def __init__(self, cfg: XLMRConfig, *, device, dtype, positions: int = MAX_POSITIONS):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.roberta = nn.Module()
        self.roberta.embeddings = _Embeddings(cfg, positions, kw)
        self.roberta.encoder = nn.Module()
        self.roberta.encoder.layer = nn.ModuleList(_Layer(cfg, kw) for _ in range(cfg.layers))
        if cfg.pre_transformation:
            self.pre_LN = _ln(cfg.hidden, cfg.eps, kw)
            self.transformation_pre = Linear(cfg.hidden, cfg.project_dim, **kw)
        else:
            self.transformation = Linear(cfg.hidden, cfg.project_dim, **kw)

    def forward(self, ids, attention_mask=None):
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = (ids != cfg.pad_token_id).to(torch.int64)
        emb = self.roberta.embeddings
        pos = torch.cumsum(attention_mask, dim=1) * attention_mask + cfg.pad_token_id
        x = emb.word_embeddings(ids) + emb.position_embeddings(pos) \
            + emb.token_type_embeddings(torch.zeros_like(ids))
        x = emb.LayerNorm(x)
        bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        penult = None
        for i, layer in enumerate(self.roberta.encoder.layer):
            if cfg.pre_transformation and i == cfg.layers - 1:
                penult = x
            x = layer(x, cfg.heads, bias)
        if cfg.pre_transformation:
            return self.transformation_pre(self.pre_LN(penult))
        return self.transformation(x)


class AltConditioner:
    """AltDiffusion's conditioner: tokenizer (text → SentencePiece ids in
    fairseq numbering) → XLM-R → the 77-token projected context
    (xlmr.py:140-169).  ``encode`` returns (context, None)."""

    def __init__(self, model: XLMRModel, cfg: XLMRConfig, tokenizer=None, max_length: int = 77):
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.embedding_db = None
        self.emphasis = "None"
        self.comma_padding_backtrack = 0
        self.clip_skip = 1

    def encode(self, texts, target_chunks=None):
        if self.tokenizer is None:
            raise RuntimeError(
                "AltDiffusion needs an XLM-R SentencePiece tokenizer: put its .model file "
                "under models/XLM-R, or assign conditioner.tokenizer (text -> ids)")
        rows = []
        for t in texts:
            ids = list(self.tokenizer(t))[: self.max_length - 2]
            rows.append([0, *ids, 2] + [self.cfg.pad_token_id] * (self.max_length - 2 - len(ids)))
        device = self.model.roberta.embeddings.word_embeddings.weight.device
        return self.model(torch.as_tensor(rows, dtype=torch.int64, device=device)), None


# --------------------------------------------------------------------------
# conversion (xlmr.py:101-137)
# --------------------------------------------------------------------------

def convert_xlmr(sd: dict, prefix: str = "cond_stage_model.", verify: bool = True):
    """→ (the XLM-R state dict, XLMRConfig, the position table's rows): the
    pooler and position_ids dropped, pre_LN kept only with the m18
    variant's transformation_pre; widths from the shapes, 64-channel heads
    (16-channel below a width of 256), as JAX derives them.  The names are
    checked against ``XLMRModel(cfg)``'s."""
    from sdwebui_tpu_torch.loader.convert import _drop_extras

    flat = {}
    m18 = any(k.startswith(prefix + "transformation_pre") for k in sd)
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        kk = k[len(prefix):]
        if kk.startswith(("roberta.pooler", "pooler", "roberta.embeddings.position_ids")):
            continue
        if kk.startswith("pre_LN") and not m18:
            continue
        flat[kk] = v
    vocab, hidden = flat["roberta.embeddings.word_embeddings.weight"].shape
    hidden = int(hidden)
    proj = flat["transformation_pre.weight" if m18 else "transformation.weight"]
    cfg = XLMRConfig(
        vocab_size=int(vocab), hidden=hidden,
        layers=1 + max(int(k.split(".")[3]) for k in flat
                       if k.startswith("roberta.encoder.layer.")),
        heads=hidden // 64 if hidden >= 256 else max(hidden // 16, 1),
        intermediate=int(flat["roberta.encoder.layer.0.intermediate.dense.weight"].shape[0]),
        project_dim=int(proj.shape[0]), pre_transformation=m18)
    positions = int(flat["roberta.embeddings.position_embeddings.weight"].shape[0])
    if verify:
        names = set(XLMRModel(cfg, device="meta", dtype=torch.float32,
                              positions=positions).state_dict())
        missing = names - set(flat)
        if missing:
            raise ValueError(f"{prefix.rstrip('.')}: checkpoint is missing {len(missing)} "
                             f"expected tensors, e.g. {sorted(missing)[:4]}")
        _drop_extras(flat, set(flat) - names, prefix.rstrip("."))
    return flat, cfg, positions


def xlmr_from_jax(tree: dict, cfg, device="cpu") -> XLMRModel:
    """The port's encoder from a JAX XLM-R tree (linears (in, out), the
    embeddings (rows, width)) and its config, in fp32."""
    import numpy as np

    from sdwebui_tpu_torch.utils.pytree import flatten

    sd = {}
    for key, leaf in flatten(tree).items():
        a = np.asarray(leaf, np.float32)
        if a.ndim == 2 and "embeddings" not in key:     # tables keep (rows, width)
            a = a.T
        sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    positions = int(sd["roberta.embeddings.position_embeddings.weight"].shape[0])
    model = XLMRModel(XLMRConfig(**dataclasses.asdict(cfg)), device=device,
                      dtype=torch.float32, positions=positions)
    model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    return model
