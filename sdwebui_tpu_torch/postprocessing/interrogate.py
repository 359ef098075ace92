"""The CLIP interrogator and the BLIP captioner of ``/sdapi/v1/interrogate``.

Port of ``sdwebui_tpu/postprocessing/interrogate.py:23-160``: the caption
is "<BLIP caption>, <the best items of each category>", the categories the
``interrogate/<name>[.topN].txt`` files, ranked by the cosine of the CLIP
image feature (``models/clip_vision``) with each item's text feature (the
same file's text tower, ``models/clip``), softmaxed over 100·cosine.  The
nets run on the device they were loaded to (fp32); their LayerNorms are
B5 on CUDA (ViT-L/14's 257 rows of 1024, the text tower's 77 rows).
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch

from sdwebui_tpu_torch.utils.options import opts

_TOPN_RE = re.compile(r"\.top(\d+)$")


def load_categories(dirpath: str = "interrogate"):
    """[(name, top n, items)] of ``<dirpath>/*.txt``."""
    out = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.txt"))):
        stem = os.path.splitext(os.path.basename(path))[0]
        m = _TOPN_RE.search(stem)
        with open(path, encoding="utf-8") as f:
            items = [line.strip() for line in f if line.strip()]
        if items:
            out.append((_TOPN_RE.sub("", stem), int(m.group(1)) if m else 1, items))
    return out


def rank(image_features: np.ndarray, text_features: np.ndarray, top_count: int = 1):
    """[(item index, probability·100)] of the top_count best items: the
    softmax over 100·cosine (clip_vision.py:225-233)."""
    sims = np.asarray(image_features @ text_features.T)[0] * 100.0
    e = np.exp(sims - sims.max())
    probs = e / e.sum()
    order = np.argsort(-probs)[:top_count]
    return [(int(i), float(probs[i] * 100.0)) for i in order]


def clip_towers(sd: dict, device):
    """An HF ``CLIPModel`` state dict → (vision tower, text tower, text
    config), fp32 on `device`; the text tower carries the projection."""
    import dataclasses

    from sdwebui_tpu_torch.loader.convert import convert_clip_hf
    from sdwebui_tpu_torch.models.clip import CLIPTextModel
    from sdwebui_tpu_torch.models.clip_vision import CLIPVisionModel, convert_clip_vision

    vflat, vcfg = convert_clip_vision(sd)
    vision = CLIPVisionModel(vcfg, device=device, dtype=torch.float32)
    vision.load_state_dict({k: v.float() for k, v in vflat.items()}, strict=True)
    tflat, tcfg = convert_clip_hf(sd, "text_model.")
    if "text_projection.weight" in sd:
        tflat["text_projection.weight"] = sd["text_projection.weight"]
        tcfg = dataclasses.replace(tcfg, projection_dim=int(sd["text_projection.weight"].shape[0]))
    text = CLIPTextModel(tcfg, device=device, dtype=torch.float32)
    text.load_state_dict({k: v.float() for k, v in tflat.items()}, strict=True)
    return vision.eval(), text.eval(), tcfg


class ClipInterrogator:
    """A full CLIP model file, loaded once; ranks the category items for
    each image."""

    def __init__(self, model_path: str, category_dir: str = "interrogate", device="cuda"):
        from sdwebui_tpu_torch.loader.load import read_checkpoint
        from sdwebui_tpu_torch.text.tokenizer import get_tokenizer
        from sdwebui_tpu_torch.utils.devices import get_device

        self.device = get_device(device)
        self.vision, self.text, self.tcfg = clip_towers(read_checkpoint(model_path), self.device)
        self.tokenizer = get_tokenizer()
        self.categories = load_categories(category_dir)
        self._text_cache: dict = {}

    @torch.inference_mode()
    def image_features(self, image: np.ndarray) -> np.ndarray:
        from sdwebui_tpu_torch.models import clip_vision

        px = torch.from_numpy(clip_vision.preprocess(image, self.vision.cfg.image_size))
        return self.vision(px.to(self.device)).float().cpu().numpy()

    @torch.inference_mode()
    def text_features(self, texts) -> np.ndarray:
        ids = []
        for t in texts:
            row = [self.tokenizer.bos_token_id, *self.tokenizer.encode(t)[:75],
                   self.tokenizer.eos_token_id]
            ids.append(row + [self.tokenizer.eos_token_id] * (77 - len(row)))
        _, pooled = self.text.encode(torch.tensor(ids, dtype=torch.long, device=self.device))
        pooled = pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled.float().cpu().numpy()

    def interrogate(self, image: np.ndarray, max_flavors: int = 3, captioner=None) -> str:
        """"<caption>, <ranked items>" with interrogate_clip_skip_categories,
        interrogate_clip_dict_limit and interrogate_return_ranks."""
        skip = set(opts.get("interrogate_clip_skip_categories", []) or [])
        limit = int(opts.get("interrogate_clip_dict_limit", 1500) or 0)
        ranks = bool(opts.get("interrogate_return_ranks", False))
        img_feat = self.image_features(image)
        parts = []
        if captioner is not None:
            parts.append(captioner.caption(image))
        for name, topn, items in self.categories:
            if name in skip:
                continue
            if limit:
                items = items[:limit]
            key = (name, limit)
            if key not in self._text_cache:
                self._text_cache[key] = self.text_features(items)
            for idx, score in rank(img_feat, self._text_cache[key], top_count=topn):
                parts.append(f"({items[idx]}:{score / 100:.3f})" if ranks else items[idx])
        return ", ".join(p for p in parts if p)


class BlipCaptioner:
    """BLIP's caption of an image after the prompt "a picture of ", the
    prompt stripped; lengths and beams from the interrogate_clip_* options."""

    PROMPT = "a picture of "

    def __init__(self, model_path: str, vocab_path: str, device="cuda"):
        from sdwebui_tpu_torch.models import blip

        self.net = blip.load_blip(model_path, device)
        self.tok = blip.WordPiece(vocab_path)

    @property
    def cfg(self):
        return self.net.cfg

    def caption(self, image: np.ndarray, max_new_tokens: int | None = None) -> str:
        from sdwebui_tpu_torch.models import blip

        if max_new_tokens is None:
            max_new_tokens = int(opts.get("interrogate_clip_max_length", 48))
        px = torch.from_numpy(blip.preprocess(image, self.cfg.image_size)).to(self.net.device)
        prompt_ids = [self.cfg.bos_token_id] + self.tok.encode(self.PROMPT)
        ids = self.net.generate(
            px, prompt_ids, max_new_tokens=max_new_tokens,
            min_new_tokens=int(opts.get("interrogate_clip_min_length", 24)),
            num_beams=int(opts.get("interrogate_clip_num_beams", 1)))
        return self.tok.decode(ids[len(prompt_ids):])


def find_clip_model(dirpath: str = os.path.join("models", "clip_vision")):
    for ext in ("*.safetensors", "*.bin", "*.pt"):
        hit = sorted(glob.glob(os.path.join(dirpath, ext)))
        if hit:
            return hit[0]
    return None


def find_blip_model(dirpath: str = os.path.join("models", "BLIP")):
    """(weights, vocab.txt) of the BLIP directory, or None."""
    vocab = os.path.join(dirpath, "vocab.txt")
    if not os.path.isfile(vocab):
        return None
    for ext in ("*.safetensors", "*.pth", "*.pt", "*.ckpt"):
        hit = sorted(glob.glob(os.path.join(dirpath, ext)))
        if hit:
            return hit[0], vocab
    return None
