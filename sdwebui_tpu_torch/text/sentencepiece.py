"""Pure-Python SentencePiece unigram tokenizer.

Copy of ``sdwebui_tpu/text/sentencepiece.py``; ``tests/test_torch_copies.py``
holds both equal.  One branch differs: the JAX package reads an HF
``tokenizer.json`` through the ``tokenizers`` wheel, which the card's
machine lacks, so this copy reads the file's Unigram vocab (pieces, scores,
``unk_id``, the special tokens) with ``json`` and segments it with the same
Viterbi as a ``.model`` file; a ``tokenizer.json`` of another model type
raises naming the file.  The T5 and XLM-R wrappers and their id
conventions are the JAX package's.

The module parses SentencePiece ``ModelProto`` files directly (protobuf
wire format: pieces, scores, piece types, trainer ids, normalizer flags)
and runs the unigram Viterbi segmentation, so a user-supplied ``.model``
file is all that is needed.  Normalization approximates sentencepiece's
nmt_nfkc with unicodedata NFKC + whitespace collapse (the precompiled
charsmap adds only a handful of NMT control-char rules on top).
"""

from __future__ import annotations

import json
import struct
import unicodedata

_SPACE = "▁"   # ▁
_UNK_PENALTY = 10.0

# SentencePiece piece types
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# --------------------------------------------------------------------------
# protobuf wire parsing (no protobuf dependency)
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int):
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(buf: bytes):
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:
            val = buf[i:i + 4]
            i += 4
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_model_proto(data: bytes):
    """→ (pieces [(text, score, type)], ids {unk,bos,eos,pad},
    flags {add_dummy_prefix, remove_extra_whitespaces})."""
    pieces = []
    ids = {"unk": 0, "bos": 1, "eos": 2, "pad": -1}
    flags = {"add_dummy_prefix": True, "remove_extra_whitespaces": True}
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:          # SentencePiece message
            text, score, typ = "", 0.0, NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    text = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    typ = v2
            pieces.append((text, score, typ))
        elif field == 2 and wire == 2:        # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 40:
                    ids["unk"] = v2
                elif f2 == 41:
                    ids["bos"] = v2
                elif f2 == 42:
                    ids["eos"] = v2
                elif f2 == 43:
                    # pad_id is an int32; -1 arrives varint-encoded as 2^64-1
                    ids["pad"] = v2 - (1 << 64) if v2 > (1 << 63) else v2
        elif field == 3 and wire == 2:        # NormalizerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3:
                    flags["add_dummy_prefix"] = bool(v2)
                elif f2 == 4:
                    flags["remove_extra_whitespaces"] = bool(v2)
    return pieces, ids, flags


# --------------------------------------------------------------------------
# unigram Viterbi
# --------------------------------------------------------------------------

class SentencePieceUnigram:
    def __init__(self, pieces, unk_id: int = 0, bos_id: int = 1,
                 eos_id: int = 2, pad_id: int = -1,
                 add_dummy_prefix: bool = True,
                 remove_extra_whitespaces: bool = True):
        self.pieces = pieces
        self.unk_id = unk_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.vocab = {}
        self.byte_ids = {}
        for i, (text, score, typ) in enumerate(pieces):
            if typ in (NORMAL, USER_DEFINED):
                self.vocab[text] = (i, score)
            elif typ == BYTE:
                self.byte_ids[int(text[1:-1], 16)] = i
        self.max_piece_len = max((len(t) for t in self.vocab), default=1)
        scores = [s for _, s, t in pieces if t == NORMAL]
        self.min_score = min(scores) if scores else 0.0
        self.unk_score = self.min_score - _UNK_PENALTY

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceUnigram":
        with open(path, "rb") as f:
            data = f.read()
        pieces, ids, flags = parse_model_proto(data)
        return cls(pieces, unk_id=ids["unk"], bos_id=ids["bos"],
                   eos_id=ids["eos"], pad_id=ids["pad"],
                   add_dummy_prefix=flags["add_dummy_prefix"],
                   remove_extra_whitespaces=flags["remove_extra_whitespaces"])

    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        if self.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.add_dummy_prefix:
            text = " " + text
        return text.replace(" ", _SPACE)

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        s = self.normalize(text)
        n = len(s)
        # Viterbi: best[i] = (score, piece_start, piece_id) ending at i
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            upper = min(n, i + self.max_piece_len)
            for j in range(i + 1, upper + 1):
                hit = self.vocab.get(s[i:j])
                if hit is not None:
                    sc = best[i] + hit[1]
                    if sc > best[j]:
                        best[j] = sc
                        back[j] = (i, hit[0])
            # unknown fallback: one character
            j = i + 1
            sc = best[i] + self.unk_score
            if sc > best[j]:
                best[j] = sc
                back[j] = (i, -1)
        out: list[int] = []
        j = n
        rev = []
        while j > 0:
            i, pid = back[j]
            if pid == -1:
                ch = s[i:j]
                if self.byte_ids:       # byte fallback
                    rev.extend(self.byte_ids[b]
                               for b in reversed(ch.encode("utf-8")))
                else:
                    rev.append(self.unk_id)
            else:
                rev.append(pid)
            j = i
        out = list(reversed(rev))
        if add_bos and self.bos_id >= 0:
            out.insert(0, self.bos_id)
        if add_eos and self.eos_id >= 0:
            out.append(self.eos_id)
        return out

    def decode(self, ids) -> str:
        parts = []
        byte_buf = []

        def flush():
            if byte_buf:
                parts.append(bytes(byte_buf).decode("utf-8", "replace"))
                byte_buf.clear()

        for i in ids:
            text, _, typ = self.pieces[int(i)]
            if typ == BYTE:
                byte_buf.append(int(text[1:-1], 16))
                continue
            flush()
            if typ in (CONTROL, UNKNOWN):
                continue
            parts.append(text)
        flush()
        return "".join(parts).replace(_SPACE, " ").strip()


# --------------------------------------------------------------------------
# loading front door
# --------------------------------------------------------------------------

class _JSONUnigram(SentencePieceUnigram):
    """An HF ``tokenizer.json``'s Unigram vocab, with the attributes the JAX
    package's ``tokenizers`` wrapper shows (no bos or eos of its own)."""

    def __init__(self, model: dict, added: list):
        special = {t["id"] for t in added if t.get("special")}
        pieces = [(text, float(score), CONTROL if i in special else NORMAL)
                  for i, (text, score) in enumerate(model["vocab"])]
        super().__init__(pieces, unk_id=int(model.get("unk_id") or 0))
        self.bos_id = self.eos_id = None


def load_sentencepiece(path: str):
    """Load a tokenizer from a sentencepiece .model proto or an HF
    tokenizer.json (its Unigram vocab, read with json); returns an object
    with .encode/.decode."""
    with open(path, "rb") as f:
        head = f.read(1)
    if head == b"{":
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec.get("model") or {}
        if model.get("type") != "Unigram" or not isinstance(model.get("vocab"), list):
            raise NotImplementedError(
                f"{path}: only a Unigram tokenizer.json is read (model type "
                f"{model.get('type')!r}); put the SentencePiece .model file there instead")
        return _JSONUnigram(model, spec.get("added_tokens") or [])
    return SentencePieceUnigram.from_file(path)


def make_t5_tokenizer(path: str, max_length: int = 77):
    """→ callable(text) → fixed-length id list (T5: pieces + </s> + <pad>
    padding), the shape models/t5.py and SDModel.encode_texts expect."""
    sp = load_sentencepiece(path)
    eos = getattr(sp, "eos_id", 1) if getattr(sp, "eos_id", None) is not None else 1
    pad = getattr(sp, "pad_id", 0)
    if pad is None or pad < 0:
        pad = 0

    def tokenize(text: str):
        ids = sp.encode(text)[: max_length - 1] + [eos]
        return ids + [pad] * (max_length - len(ids))

    return tokenize


def make_xlmr_tokenizer(path: str):
    """→ callable(text) → raw piece ids in XLM-R's fairseq numbering
    (<s>=0, <pad>=1, </s>=2, <unk>=3, spm pieces shifted +1); the
    AltConditioner adds bos/eos itself."""
    sp = load_sentencepiece(path)
    if isinstance(sp, _JSONUnigram):
        # the JAX package's wrapper has no unk_id: it raises there too
        raise NotImplementedError(
            f"{path}: an XLM-R tokenizer.json is not read (its ids are not the "
            "SentencePiece numbering the fairseq shift expects); use the .model file")

    def tokenize(text: str):
        # spm id 0 = <unk> → fairseq 3; others shift by +1
        return [3 if i == sp.unk_id else i + 1 for i in sp.encode(text)]

    return tokenize
