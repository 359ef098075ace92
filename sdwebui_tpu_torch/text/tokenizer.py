"""CLIP byte-pair-encoding tokenizer — from-scratch implementation.

The reference relies on `transformers.CLIPTokenizer` (hub-downloaded
vocab.json/merges.txt; modules/sd_hijack_clip.py).  This environment has
zero egress, so we implement the BPE algorithm ourselves and load vocab
assets from (in order): an explicit path, the HF cache if present, or a
deterministic byte-level fallback vocab (every byte is a token — correct
plumbing, stable ids, usable with random-weight models and CI, mirroring
the reference CI's `--do-not-download-clip` empty-checkpoint mode).

Token contract (CLIP-L and OpenCLIP share it): vocab 49408,
BOS=49406, EOS=49407, comma=267 (`,</w>`), word tokens end in `</w>`.

Copy of ``sdwebui_tpu/text/tokenizer.py``.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import List

BOS = 49406
EOS = 49407
COMMA = 267
VOCAB_SIZE = 49408


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2 byte↔unicode table (public algorithm)."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_WORD_RE = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\w]+|[\d]|[^\s\w\d]+""",
    re.IGNORECASE)


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class ClipBPETokenizer:
    """Real CLIP BPE given vocab.json + merges.txt."""

    def __init__(self, vocab: dict, merges: List[tuple]):
        self.encoder = vocab
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {}
        self.eos_token_id = EOS
        self.bos_token_id = BOS

    @staticmethod
    def from_files(vocab_path: str, merges_path: str) -> "ClipBPETokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#") and len(l.split()) == 2]
        return ClipBPETokenizer(vocab, merges)

    def _bpe(self, token: str) -> List[str]:
        """token: byte-encoded word WITHOUT suffix; CLIP fuses '</w>' onto
        the final character before merging."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self.cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in _WORD_RE.findall(_clean(text)):
            token = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            for piece in self._bpe(token):
                ids.append(self.encoder.get(piece, 0))
        return ids


class FallbackTokenizer:
    """Deterministic byte-level tokenizer for environments without vocab
    assets: each utf-8 byte of each word → id 320+byte; words separated by
    id 600+len%100 marker-free (</w> semantics folded into the byte of the
    last char via +256 offset... kept simple: bytes only).  Comma maps to
    the real CLIP comma id so comma-backtracking logic stays testable."""

    eos_token_id = EOS
    bos_token_id = BOS

    #: the paren/bracket single-byte word tokens (ASCII + 1000 + 256 </w>
    #: variant) — lets vocab-scanning consumers (the old-emphasis
    #: token_mults table) work against the fallback too
    encoder = {"(</w>": 1296, ")</w>": 1297, "[</w>": 1347, "]</w>": 1349}

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in _WORD_RE.findall(_clean(text)):
            if word == ",":
                ids.append(COMMA)
                continue
            data = word.encode("utf-8")
            for i, b in enumerate(data):
                # last byte of a word carries the </w> (+256) variant
                ids.append(1000 + b + (256 if i == len(data) - 1 else 0))
        return ids


def _hf_cache_candidates():
    home = os.environ.get("HF_HOME") or os.path.expanduser("~/.cache/huggingface")
    pats = []
    hub = os.path.join(home, "hub")
    if os.path.isdir(hub):
        for d in os.listdir(hub):
            if "clip" in d.lower():
                for root, _, files in os.walk(os.path.join(hub, d)):
                    if "vocab.json" in files and "merges.txt" in files:
                        pats.append((os.path.join(root, "vocab.json"),
                                     os.path.join(root, "merges.txt")))
    return pats


@functools.lru_cache(maxsize=4)
def get_tokenizer(vocab_dir: str | None = None):
    """Best available tokenizer. vocab_dir may contain vocab.json+merges.txt
    (or bpe_simple_vocab_16e6.txt.gz open_clip style is NOT supported yet)."""
    if vocab_dir:
        v = os.path.join(vocab_dir, "vocab.json")
        m = os.path.join(vocab_dir, "merges.txt")
        if os.path.exists(v) and os.path.exists(m):
            return ClipBPETokenizer.from_files(v, m)
    for v, m in _hf_cache_candidates():
        try:
            return ClipBPETokenizer.from_files(v, m)
        except Exception:
            continue
    return FallbackTokenizer()
