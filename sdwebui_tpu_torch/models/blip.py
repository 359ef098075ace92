"""BLIP captioner: the ViT vision tower and the BERT decoder with
cross-attention.

Port of ``sdwebui_tpu/models/blip.py:31-350``, over the HF
``BlipForConditionalGeneration`` state dict (``vision_model.*``,
``text_decoder.*``; the BLIP repo's ``visual_encoder.*`` layout converts
into it) held as fp32 tensors in torch's layouts.  The LayerNorms go
through ``ops.norms.layer_norm`` (B5 on CUDA: the ViT-B/16's 577 rows of
768 at 384², the decoder's rows of 768); the attention is plain (fewer
than 1024 keys, the rule of ``ops/attention.py``), q scaled before qᵀk and
the softmax in fp32, as JAX's.  ``generate`` is JAX's greedy and beam
decode: each step runs the decoder over the whole prefix and reads the
last position's logits.  ``WordPiece`` restates JAX's tokenizer over a
``vocab.txt``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from sdwebui_tpu_torch.ops.norms import layer_norm
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.devices import get_device

_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    # vision
    hidden_size: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    image_size: int = 384
    patch_size: int = 16
    vision_eps: float = 1e-5
    # text decoder (BERT)
    text_hidden: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_intermediate: int = 3072
    vocab_size: int = 30524
    max_positions: int = 512
    # special ids (BERT's and BLIP's [DEC])
    bos_token_id: int = 30522
    sep_token_id: int = 102
    pad_token_id: int = 0


def _heads_attn(q, k, v, heads: int, mask=None):
    b, sq, d = q.shape
    sk = k.shape[1]
    hd = d // heads
    qh = q.reshape(b, sq, heads, hd).transpose(1, 2)
    kh = k.reshape(b, sk, heads, hd).transpose(1, 2)
    vh = v.reshape(b, sk, heads, hd).transpose(1, 2)
    att = (qh * (hd ** -0.5)) @ kh.transpose(-1, -2)
    if mask is not None:
        att = att + mask
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    return (att @ vh).transpose(1, 2).reshape(b, sq, d)


class Blip:
    """The captioner's tensors (HF names) and config on one device."""

    def __init__(self, sd: dict, cfg: BlipConfig):
        self.sd, self.cfg = sd, cfg

    @property
    def device(self) -> torch.device:
        return next(iter(self.sd.values())).device

    def to(self, device) -> "Blip":
        self.sd = {k: v.to(device) for k, v in self.sd.items()}
        return self

    def _lin(self, name: str, x):
        return F.linear(x, self.sd[name + ".weight"], self.sd.get(name + ".bias"))

    def _ln(self, name: str, x, eps: float):
        return layer_norm(x.float(), self.sd[name + ".weight"], self.sd[name + ".bias"], eps)

    def vision(self, pixels):
        """pixels (B, 3, S, S), normalised → (B, 1 + N, D) encoder states."""
        cfg, sd = self.cfg, self.sd
        e = "vision_model.embeddings."
        x = F.conv2d(pixels, sd[e + "patch_embedding.weight"], sd[e + "patch_embedding.bias"],
                     cfg.patch_size)
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)
        cls = sd[e + "class_embedding"].reshape(1, 1, -1).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + sd[e + "position_embedding"].reshape(-1, x.shape[-1])[None, : x.shape[1]]
        for i in range(cfg.layers):
            p = f"vision_model.encoder.layers.{i}."
            h = self._ln(p + "layer_norm1", x, cfg.vision_eps)
            q, k, v = self._lin(p + "self_attn.qkv", h).chunk(3, dim=-1)
            x = x + self._lin(p + "self_attn.projection", _heads_attn(q, k, v, cfg.heads))
            h = self._ln(p + "layer_norm2", x, cfg.vision_eps)
            x = x + self._lin(p + "mlp.fc2", F.gelu(self._lin(p + "mlp.fc1", h)))
        return self._ln("vision_model.post_layernorm", x, cfg.vision_eps)

    def decoder_logits(self, ids, enc, attn_mask=None):
        """ids (B, L) int; enc (B, S, D) → (B, L, vocab) logits."""
        cfg, sd, eps = self.cfg, self.sd, 1e-12
        e = "text_decoder.bert.embeddings."
        length = ids.shape[1]
        x = sd[e + "word_embeddings.weight"][ids] \
            + sd[e + "position_embeddings.weight"][:length][None]
        x = self._ln(e + "LayerNorm", x, eps)
        ar = torch.arange(length, device=x.device)
        mask = torch.where(ar[None, :] <= ar[:, None], 0.0, -1e9)[None, None]
        if attn_mask is not None:     # (B, L): 1 for a real token
            mask = mask + torch.where(attn_mask[:, None, None, :] > 0, 0.0, -1e9)
        for i in range(cfg.text_layers):
            p = f"text_decoder.bert.encoder.layer.{i}."
            a = p + "attention."
            att = _heads_attn(self._lin(a + "self.query", x), self._lin(a + "self.key", x),
                              self._lin(a + "self.value", x), cfg.text_heads, mask)
            x = self._ln(a + "output.LayerNorm", x + self._lin(a + "output.dense", att), eps)
            c = p + "crossattention."
            att = _heads_attn(self._lin(c + "self.query", x), self._lin(c + "self.key", enc),
                              self._lin(c + "self.value", enc), cfg.text_heads)
            x = self._ln(c + "output.LayerNorm", x + self._lin(c + "output.dense", att), eps)
            h = F.gelu(self._lin(p + "intermediate.dense", x))
            x = self._ln(p + "output.LayerNorm", x + self._lin(p + "output.dense", h), eps)
        t = "text_decoder.cls.predictions."
        h = F.gelu(self._lin(t + "transform.dense", x))
        h = self._ln(t + "transform.LayerNorm", h, eps)
        return h @ sd[t + "decoder.weight"].T + sd[t + "bias"]

    @torch.inference_mode()
    def generate(self, pixels, prompt_ids, max_new_tokens: int = 20, min_new_tokens: int = 0,
                 num_beams: int = 1) -> np.ndarray:
        """The caption's ids (the prompt's, then the generated ones up to
        [SEP]): greedy with num_beams 1, else beam search ranked by log
        probability over the generated length; [SEP] is barred before
        min_new_tokens (blip.py:165-215)."""
        cfg = self.cfg
        enc = self.vision(pixels)

        def step_logits(ids) -> np.ndarray:
            t = torch.as_tensor(np.asarray(ids, np.int64), device=enc.device)
            return self.decoder_logits(t, enc)[0, -1].float().cpu().numpy()

        if num_beams <= 1:
            ids = [list(prompt_ids)]
            for t in range(max_new_tokens):
                logits = step_logits(ids)
                if t < min_new_tokens:
                    logits[cfg.sep_token_id] = -np.inf
                nxt = int(np.argmax(logits))
                ids = [ids[0] + [nxt]]
                if nxt == cfg.sep_token_id:
                    break
            return np.asarray(ids[0], np.int32)
        beams = [(list(prompt_ids), 0.0, False)]      # (ids, log prob, finished)
        for t in range(max_new_tokens):
            if all(f for _, _, f in beams):
                break
            cand = []
            for ids, lp, fin in beams:
                if fin:
                    cand.append((ids, lp, True))
                    continue
                logits = step_logits([ids])
                logp = logits - np.logaddexp.reduce(logits)
                if t < min_new_tokens:
                    logp[cfg.sep_token_id] = -np.inf
                for tok in np.argpartition(-logp, num_beams)[:num_beams]:
                    cand.append((ids + [int(tok)], lp + float(logp[tok]),
                                 int(tok) == cfg.sep_token_id))
            cand.sort(key=lambda b: b[1], reverse=True)
            beams = cand[:num_beams]
        n0 = len(prompt_ids)
        best = max(beams, key=lambda b: b[1] / max(len(b[0]) - n0, 1))
        return np.asarray(best[0], np.int32)


def preprocess(image: np.ndarray, image_size: int) -> np.ndarray:
    """uint8 (H, W, C) → (1, 3, S, S) normalised: RGB, Pillow's bicubic
    resize to S²."""
    img = images_util.resize(images_util.to_rgb(image), (image_size, image_size), "bicubic")
    arr = (img.astype(np.float32) / 255.0 - _MEAN) / _STD
    return np.ascontiguousarray(arr.transpose(2, 0, 1)[None])


class WordPiece:
    """BERT's greedy longest-match WordPiece over a vocab.txt (lower-cased,
    split on whitespace); decode drops [special] tokens and joins ##
    pieces (blip.py:232-278)."""

    def __init__(self, vocab_path: str):
        with open(vocab_path, encoding="utf-8") as f:
            self.tokens = [line.rstrip("\n") for line in f]
        self.ids = {t: i for i, t in enumerate(self.tokens)}

    def encode_word(self, word: str) -> list[int]:
        out, start = [], 0
        while start < len(word):
            end, piece = len(word), None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.ids:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.ids.get("[UNK]", 100)]
            out.append(self.ids[piece])
            start = end
        return out

    def encode(self, text: str) -> list[int]:
        ids = []
        for w in text.lower().split():
            ids += self.encode_word(w)
        return ids

    def decode(self, ids) -> str:
        words: list = []
        for i in ids:
            t = self.tokens[int(i)]
            if t.startswith("["):
                continue
            if t.startswith("##") and words:
                words[-1] += t[2:]
            else:
                words.append(t)
        return " ".join(words)


# --------------------------------------------------------------------------
# loading (blip.py:281-350)
# --------------------------------------------------------------------------

_ORIGINAL = (("norm1.", "layer_norm1."), ("norm2.", "layer_norm2."),
             ("attn.qkv.", "self_attn.qkv."), ("attn.proj.", "self_attn.projection."))


def _translate_original(sd: dict) -> dict:
    """The BLIP repo's layout (timm ``visual_encoder.*``) → HF's keys; the
    BERT half is named alike already."""
    out = {}
    for k, v in sd.items():
        if k.startswith("text_decoder."):
            out[k] = v
        elif k == "visual_encoder.cls_token":
            out["vision_model.embeddings.class_embedding"] = v
        elif k == "visual_encoder.pos_embed":
            out["vision_model.embeddings.position_embedding"] = v
        elif k.startswith("visual_encoder.patch_embed.proj."):
            out["vision_model.embeddings.patch_embedding." + k.rsplit(".", 1)[1]] = v
        elif k.startswith("visual_encoder.norm."):
            out["vision_model.post_layernorm." + k.rsplit(".", 1)[1]] = v
        elif k.startswith("visual_encoder.blocks."):
            parts = k.split(".")
            rest = ".".join(parts[3:])
            for old, new in _ORIGINAL:
                rest = rest.replace(old, new)
            out[f"vision_model.encoder.layers.{parts[2]}." + rest] = v
    return out


def random_state_dict(cfg: BlipConfig = BlipConfig(), seed: int = 0,
                      dtype=torch.float16) -> dict:
    """The HF keys the captioner reads, random from `seed` (linears
    normal·1/√fan-in, embeddings 0.02·normal, norms 1 and 0), in `dtype`."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(name, cout, cin):
        sd[name + ".weight"] = torch.randn((cout, cin), generator=gen) / float(np.sqrt(cin))
        sd[name + ".bias"] = torch.zeros(cout)

    def norm(name, c):
        sd[name + ".weight"], sd[name + ".bias"] = torch.ones(c), torch.zeros(c)

    d, p, t = cfg.hidden_size, cfg.patch_size, cfg.text_hidden
    e = "vision_model.embeddings."
    sd[e + "class_embedding"] = torch.randn((1, 1, d), generator=gen) * 0.02
    sd[e + "patch_embedding.weight"] = torch.randn((d, 3, p, p), generator=gen) \
        / float(np.sqrt(3 * p * p))
    sd[e + "patch_embedding.bias"] = torch.zeros(d)
    n = (cfg.image_size // p) ** 2 + 1
    sd[e + "position_embedding"] = torch.randn((1, n, d), generator=gen) * 0.02
    for i in range(cfg.layers):
        v = f"vision_model.encoder.layers.{i}."
        norm(v + "layer_norm1", d)
        lin(v + "self_attn.qkv", 3 * d, d)
        lin(v + "self_attn.projection", d, d)
        norm(v + "layer_norm2", d)
        lin(v + "mlp.fc1", cfg.intermediate, d)
        lin(v + "mlp.fc2", d, cfg.intermediate)
    norm("vision_model.post_layernorm", d)
    b = "text_decoder.bert.embeddings."
    sd[b + "word_embeddings.weight"] = torch.randn((cfg.vocab_size, t), generator=gen) * 0.02
    sd[b + "position_embeddings.weight"] = torch.randn((cfg.max_positions, t),
                                                       generator=gen) * 0.02
    norm(b + "LayerNorm", t)
    for i in range(cfg.text_layers):
        q = f"text_decoder.bert.encoder.layer.{i}."
        for part, kv in (("attention.", t), ("crossattention.", d)):
            lin(q + part + "self.query", t, t)
            lin(q + part + "self.key", t, kv)
            lin(q + part + "self.value", t, kv)
            lin(q + part + "output.dense", t, t)
            norm(q + part + "output.LayerNorm", t)
        lin(q + "intermediate.dense", cfg.text_intermediate, t)
        lin(q + "output.dense", t, cfg.text_intermediate)
        norm(q + "output.LayerNorm", t)
    c = "text_decoder.cls.predictions."
    lin(c + "transform.dense", t, t)
    norm(c + "transform.LayerNorm", t)
    sd[c + "decoder.weight"] = sd[b + "word_embeddings.weight"]
    sd[c + "bias"] = torch.zeros(cfg.vocab_size)
    return {k: v.to(dtype).contiguous() for k, v in sd.items()}


def convert_blip(sd: dict, device="cpu") -> Blip:
    """A BLIP state dict (HF or the BLIP repo's layout) → the captioner,
    its config derived from the shapes (BERT's special ids)."""
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    if any(k.startswith("visual_encoder.") for k in sd):
        sd = _translate_original(sd)
    device = get_device(device)
    flat = {k: torch.as_tensor(v).to(device, torch.float32) for k, v in sd.items()
            if ".position_ids" not in k and not k.startswith("text_encoder.")}
    e = "vision_model.embeddings."
    d = flat[e + "class_embedding"].shape[-1]
    n_pos = flat[e + "position_embedding"].shape[-2]
    layers = 1 + max(int(k.split(".")[3]) for k in flat
                     if k.startswith("vision_model.encoder.layers."))
    patch = flat[e + "patch_embedding.weight"].shape[-1]
    words = flat["text_decoder.bert.embeddings.word_embeddings.weight"]
    t_layers = 1 + max(int(k.split(".")[4]) for k in flat
                       if k.startswith("text_decoder.bert.encoder.layer."))
    cfg = BlipConfig(
        hidden_size=d, layers=layers, heads=max(d // 64, 1),
        intermediate=flat["vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
        image_size=int(np.sqrt(n_pos - 1)) * patch, patch_size=patch,
        text_hidden=words.shape[1], text_layers=t_layers,
        text_heads=max(words.shape[1] // 64, 1),
        text_intermediate=flat["text_decoder.bert.encoder.layer.0.intermediate.dense.weight"]
        .shape[0], vocab_size=words.shape[0])
    return Blip(flat, cfg)


def load_blip(path: str, device="cuda") -> Blip:
    from sdwebui_tpu_torch.loader.load import read_checkpoint

    return convert_blip(read_checkpoint(path), device)


def blip_from_jax(tree: dict, cfg, device="cpu") -> Blip:
    """The captioner from a JAX ``convert_blip`` tree (HF names, the patch
    conv HWIO) and its config."""
    from sdwebui_tpu_torch.utils.pytree import flatten

    sd = {}
    for k, v in flatten(tree).items():
        a = np.asarray(v, np.float32)
        if k.endswith("patch_embedding.weight"):
            a = a.transpose(3, 2, 0, 1)
        sd[k] = torch.from_numpy(np.ascontiguousarray(a)).to(get_device(device))
    return Blip(sd, BlipConfig(**dataclasses.asdict(cfg)))
