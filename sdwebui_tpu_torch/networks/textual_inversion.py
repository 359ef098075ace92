"""Textual-inversion embeddings: the registry and what tokenization looks up.

Port of ``sdwebui_tpu/networks/textual_inversion.py:19-45,62-163``.
Embeddings load from ``.safetensors`` (``emb_params``, or SDXL's
``clip_l`` / ``clip_g`` pair), ``.pt`` (``string_to_param``) and ``.bin``
(diffusers' ``{name: tensor}``) and PNG embedding cards (the
``sd-ti-embedding`` text chunk or the pixel panels,
``networks/image_embedding``); WebP cards raise ``NotImplementedError``.  Triggers match on token ids while a prompt is
tokenized (``TextConditioner.tokenize_line``), and each match is logged in
``used_names`` for the infotext's "TI hashes" field.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle

import numpy as np
import torch

from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict
from sdwebui_tpu_torch.loader.torch_ckpt import load_torch_checkpoint
from sdwebui_tpu_torch.networks.image_embedding import (embedding_from_b64,
                                                        extract_image_data_embed)
from sdwebui_tpu_torch.utils.image_io import read_image_file
from sdwebui_tpu_torch.utils.options import opts

#: where embeddings live unless the caller says otherwise
DEFAULT_EMBEDDINGS_DIR = "embeddings"

_EXTS = (".pt", ".safetensors", ".bin", ".png", ".webp")


@dataclasses.dataclass
class Embedding:
    name: str
    vec: torch.Tensor                       # (vectors, width), fp32 on the host
    vec_g: torch.Tensor | None = None       # SDXL: the bigG encoder's rows
    step: int | None = None
    shorthash: str | None = None

    @property
    def vectors(self) -> int:
        return int(self.vec.shape[0])


def as_rows(t) -> torch.Tensor:
    """A tensor of embedding vectors → fp32 (vectors, width)."""
    t = torch.as_tensor(t).float()
    return t.reshape(1, -1) if t.dim() == 1 else t


def load_embedding_file(path: str, name: str | None = None) -> Embedding:
    """An embedding file → Embedding, its shorthash the file's sha256[:10]."""
    name = name or os.path.splitext(os.path.basename(path))[0]
    if path.lower().endswith((".png", ".webp")):
        emb = _load_image_card(path, name)
    else:
        emb = _load_tensor_file(path, name)
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    emb.shorthash = h.hexdigest()[:10]
    return emb


def _load_image_card(path: str, name: str) -> Embedding:
    """A PNG or WebP embedding card (textual_inversion.py:47-67 of the JAX
    package), read in whatever format it holds: a PNG's
    ``sd-ti-embedding`` text chunk first, then the pixel panels; the card's
    own name and step."""
    image, text = read_image_file(path)
    data = None
    if "sd-ti-embedding" in text:
        data = embedding_from_b64(text["sd-ti-embedding"])
    if data is None:
        data = extract_image_data_embed(image)
    if not data:
        raise ValueError(f"no embedded embedding data in {path}")
    vec = np.atleast_2d(np.asarray(next(iter(data["string_to_param"].values())), np.float32))
    return Embedding(data.get("name", name), as_rows(torch.from_numpy(vec)),
                     step=data.get("step"))


def _load_tensor_file(path: str, name: str) -> Embedding:
    sd = read_state_dict(path) if path.endswith(".safetensors") else load_torch_checkpoint(path)
    if "emb_params" in sd:
        emb = Embedding(name, as_rows(sd["emb_params"]))
    elif "clip_l" in sd:    # SDXL dual embedding
        emb = Embedding(name, as_rows(sd["clip_l"]), vec_g=as_rows(sd["clip_g"]))
    elif sd:                # .pt string_to_param.*, .bin {name: tensor}
        emb = Embedding(name, as_rows(next(iter(sd.values()))))
    else:
        raise ValueError(f"no embedding tensor found in {path}")
    return emb


class EmbeddingDatabase:
    """Token-sequence-triggered embeddings of one model.  expected_dim: the
    primary encoder's width; expected_dim_g: SDXL's bigG width, whose rows
    (``vec_g``) an embedding must then carry too.  Others are skipped by
    name."""

    def __init__(self, tokenizer=None, expected_dim: int | None = None,
                 expected_dim_g: int | None = None):
        self.tokenizer = tokenizer
        self.expected_dim = expected_dim
        self.expected_dim_g = expected_dim_g
        self.embeddings: dict[str, Embedding] = {}
        self.ids_lookup: dict[int, list] = {}
        self.skipped: list[str] = []
        self.used_names: set = set()

    def register(self, emb: Embedding):
        if self.expected_dim is not None and emb.vec.shape[1] != self.expected_dim:
            self.skipped.append(f"{emb.name} (dim {emb.vec.shape[1]} != {self.expected_dim})")
            return
        if self.expected_dim_g is not None and (
                emb.vec_g is None or emb.vec_g.shape[1] != self.expected_dim_g):
            self.skipped.append(f"{emb.name} (no {self.expected_dim_g}-wide clip_g rows)")
            return
        self.embeddings[emb.name] = emb
        if self.tokenizer is None:
            return
        ids = self.tokenizer.encode(emb.name)
        if not ids:
            return
        first = ids[0]
        self.ids_lookup[first] = sorted(self.ids_lookup.get(first, []) + [(ids, emb)],
                                        key=lambda x: len(x[0]), reverse=True)

    def load_from_dir(self, dirpath: str):
        if not os.path.isdir(dirpath):
            return
        n_before = len(self.embeddings)
        for fn in sorted(os.listdir(dirpath)):
            if not fn.lower().endswith(_EXTS):
                continue
            try:
                self.register(load_embedding_file(os.path.join(dirpath, fn)))
            except (NotImplementedError, ValueError, OSError, RuntimeError,
                    pickle.UnpicklingError) as e:
                self.skipped.append(f"{fn} ({e})")
        if opts.get("textual_inversion_print_at_load", False):
            print(f"Textual inversion embeddings loaded({len(self.embeddings) - n_before} new, "
                  f"{len(self.embeddings)} total): {', '.join(sorted(self.embeddings))}",
                  flush=True)

    def find_at(self, ids: list, position: int):
        """(embedding, token count consumed) at ids[position], else (None, 0)."""
        for trigger_ids, emb in self.ids_lookup.get(ids[position], ()):
            if ids[position: position + len(trigger_ids)] == trigger_ids:
                self.used_names.add(emb.name)
                return emb, len(trigger_ids)
        return None, 0


def attach_embeddings(model, dirpath: str = DEFAULT_EMBEDDINGS_DIR) -> EmbeddingDatabase | None:
    """A new database of the embeddings under `dirpath` for `model`'s text
    encoders (``sdwebui_tpu/server/app.py:143-154``): held to the primary
    encoder's width, and for SDXL's bigG (the base's second encoder, the
    refiner's only one) to its width through the ``clip_g`` rows."""
    cond, cond2 = model.conditioner, model.conditioner2
    if model.kind == "alt":      # XLM-R is no CLIP: no embeddings, as in JAX (app.py:146-149)
        return None
    if model.kind == "sdxl-refiner":
        db = EmbeddingDatabase(cond.tokenizer, None, cond.cfg.width)
        cond.embedding_field = "vec_g"
    elif model.kind == "sdxl":
        db = EmbeddingDatabase(cond.tokenizer, cond.cfg.width, cond2.cfg.width)
        cond2.embedding_field = "vec_g"
    else:
        db = EmbeddingDatabase(cond.tokenizer, cond.cfg.width)
    db.load_from_dir(dirpath)
    for c in (cond, cond2):
        if c is not None:
            c.embedding_db = db
    return db
