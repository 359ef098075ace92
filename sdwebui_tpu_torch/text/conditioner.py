"""Prompt → conditioning tensors: chunked CLIP encoding and CFG schedules.

Port of ``sdwebui_tpu/text/conditioner.py``: 75-token chunks with BOS/EOS
framing, comma backtracking, the BREAK keyword, textual-inversion
embeddings spliced in after the token embedding (``fixes``), per-token
emphasis with per-item mean renormalisation, clip skip; then the
prompt-edit/AND schedules assembled into a ``CondSchedule``.  Tokenizer
and prompt parser are the port's copies (``text/tokenizer.py``,
``text/prompt_parser.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from sdwebui_tpu_torch.models.configs import CLIPTextConfig
from sdwebui_tpu_torch.sampling.cfg import CondSchedule
from sdwebui_tpu_torch.text import prompt_parser
from sdwebui_tpu_torch.text.tokenizer import BOS, COMMA, EOS

CHUNK_LEN = 75


@dataclasses.dataclass
class PromptChunk:
    tokens: list          # 75 ids (no specials)
    multipliers: list     # 75 floats
    # (position in the chunk, Embedding): textual-inversion splice points
    fixes: list = dataclasses.field(default_factory=list)


def apply_emphasis(z, multipliers, mode: str = "Original"):
    """z: (N, 77, D); multipliers: (N, 77).  Per-item means with a NaN guard
    (conditioner.py:37-54)."""
    if mode in ("None", "Ignore"):
        return z
    m = multipliers.float()[..., None]
    if mode == "No norm":
        return (z.float() * m).to(z.dtype)
    original_mean = z.float().mean(dim=(1, 2), keepdim=True)
    zm = z.float() * m
    new_mean = zm.mean(dim=(1, 2), keepdim=True)
    ratio = torch.where(new_mean.abs() > 1e-9, original_mean / new_mean,
                        torch.ones_like(new_mean))
    return (zm * ratio).to(z.dtype)


class TextConditioner:
    """One text encoder (CLIP-L) + tokenizer + options.  embedding_db: the
    textual-inversion registry (``networks/textual_inversion``), read at
    tokenize time; embedding_field: which rows of an embedding this encoder
    takes ("vec", or "vec_g" for SDXL's bigG)."""

    def __init__(self, model, cfg: CLIPTextConfig, tokenizer,
                 clip_skip: int = 1, emphasis: str = "Original",
                 comma_padding_backtrack: int = 20,
                 apply_final_norm: bool = True):
        self.model = model      # models.clip.CLIPTextModel
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.clip_skip = clip_skip
        self.emphasis = emphasis
        self.comma_padding_backtrack = comma_padding_backtrack
        self.apply_final_norm = apply_final_norm
        self.embedding_db = None
        self.embedding_field = "vec"

    def _token_mults(self) -> dict:
        """token id → nesting multiplier of the vocabulary entries that hold
        literal paren/bracket characters (conditioner.py:80-106): the old
        emphasis reads emphasis from tokens, not from a parsed tree."""
        cached = getattr(self, "_token_mults_cache", None)
        if cached is not None:
            return cached
        mults = {}
        for text, ident in getattr(self.tokenizer, "encoder", {}).items():
            if not any(c in str(text) for c in "()[]"):
                continue
            m = 1.0
            for c in str(text):
                if c == "[":
                    m /= 1.1
                elif c == "]":
                    m *= 1.1
                elif c == "(":
                    m *= 1.1
                elif c == ")":
                    m /= 1.1
            if m != 1.0:
                mults[ident] = m
        self._token_mults_cache = mults
        return mults

    def _tokenize_line_old(self, line: str):
        """opts.use_old_emphasis_implementation (conditioner.py:109-149):
        one 75-token window (no chunking, no BREAK, no comma backtrack),
        literal paren/bracket tokens multiplying the weight of what follows,
        the overflow cut."""
        ids = self.tokenizer.encode(line)
        token_mults = self._token_mults()
        tokens, mults, fixes = [], [], []
        mult = 1.0
        i = 0
        while i < len(ids):
            token = ids[i]
            change = token_mults.get(token) if self.emphasis != "None" else None
            if change is not None:
                mult *= change
                i += 1
                continue
            if self.embedding_db is not None:
                emb, emb_len = self.embedding_db.find_at(ids, i)
                if emb is not None:
                    fixes.append((len(tokens), emb))
                    tokens += [0] * emb.vectors
                    mults += [mult] * emb.vectors
                    i += emb_len
                    continue
            tokens.append(token)
            mults.append(mult)
            i += 1
        token_count = len(tokens)
        tokens, mults = tokens[:CHUNK_LEN], mults[:CHUNK_LEN]
        fixes = [(pos, e) for (pos, e) in fixes if pos < CHUNK_LEN]
        tokens += [EOS] * (CHUNK_LEN - len(tokens))
        mults += [1.0] * (CHUNK_LEN - len(mults))
        return [PromptChunk(tokens, mults, fixes)], token_count

    def tokenize_line(self, line: str):
        """line → (List[PromptChunk], token_count) (reference
        sd_hijack_clip.py:81 semantics)."""
        from sdwebui_tpu_torch.utils.options import opts

        if bool(opts.get("use_old_emphasis_implementation", False)):
            return self._tokenize_line_old(line)
        parsed = prompt_parser.parse_prompt_attention(line)

        chunks: List[PromptChunk] = []
        tokens: list = []
        mults: list = []
        fixes: list = []
        last_comma = -1
        token_count = 0

        def next_chunk(is_last=False):
            nonlocal tokens, mults, fixes, token_count
            token_count += len(tokens) if is_last else CHUNK_LEN
            to_add = CHUNK_LEN - len(tokens)
            if to_add > 0:
                tokens += [EOS] * to_add
                mults += [1.0] * to_add
            chunks.append(PromptChunk(tokens, mults, fixes))
            tokens, mults, fixes = [], [], []

        for text, weight in parsed:
            if text == "BREAK" and weight == -1:
                next_chunk()
                continue
            ids = self.tokenizer.encode(text)
            position = 0
            while position < len(ids):
                token = ids[position]
                if token == COMMA:
                    last_comma = len(tokens)
                elif (self.comma_padding_backtrack != 0 and len(tokens) == CHUNK_LEN
                        and last_comma != -1
                        and len(tokens) - last_comma <= self.comma_padding_backtrack):
                    # move everything since the last comma to the next chunk
                    break_location = last_comma + 1
                    reloc_tokens = tokens[break_location:]
                    reloc_mults = mults[break_location:]
                    tokens = tokens[:break_location]
                    mults = mults[:break_location]
                    next_chunk()
                    tokens = reloc_tokens
                    mults = reloc_mults
                    last_comma = -1
                if len(tokens) == CHUNK_LEN:
                    next_chunk()
                    last_comma = -1
                emb, emb_len = (None, 0) if self.embedding_db is None \
                    else self.embedding_db.find_at(ids, position)
                if emb is not None:
                    # the embedding's vectors stay in one chunk
                    if len(tokens) + emb.vectors > CHUNK_LEN:
                        next_chunk()
                        last_comma = -1
                    fixes.append((len(tokens), emb))
                    tokens += [0] * emb.vectors
                    mults += [weight] * emb.vectors
                    position += emb_len
                    continue
                tokens.append(token)
                mults.append(weight)
                position += 1

        if tokens or not chunks:
            next_chunk(is_last=True)
        return chunks, token_count

    @torch.inference_mode()
    def encode(self, lines: List[str], target_chunks: int | None = None):
        """lines → (cond (B, 77·C, D), pooled (B, Dp)), every line padded to a
        common chunk count (and to `target_chunks` when given).  pooled is
        the first chunk's EOT pool (conditioner.py:233-265)."""
        per_line = [self.tokenize_line(line) for line in lines]
        n_chunks = max(max(len(c) for c, _ in per_line), target_chunks or 1)
        empty = PromptChunk([EOS] * CHUNK_LEN, [1.0] * CHUNK_LEN)
        all_tokens, all_mults, all_fixes = [], [], []
        for chunks, _ in per_line:
            for ch in chunks + [empty] * (n_chunks - len(chunks)):
                all_tokens.append([BOS] + ch.tokens + [EOS])
                all_mults.append([1.0] + ch.multipliers + [1.0])
                all_fixes.append(ch.fixes)
        device = self.model.final_layer_norm.weight.device
        tokens = torch.as_tensor(np.asarray(all_tokens, np.int64), device=device)
        mults = torch.as_tensor(np.asarray(all_mults, np.float32), device=device)
        hidden, pooled = self.model.encode(tokens, stop_at_layer=self.clip_skip - 1,
                                           apply_final_norm=self.apply_final_norm,
                                           inputs_embeds=self._embeds_with_fixes(tokens, all_fixes))
        hidden = apply_emphasis(hidden, mults, self.emphasis)
        b = len(lines)
        cond = hidden.reshape(b, n_chunks * (CHUNK_LEN + 2), hidden.shape[-1])
        pooled = pooled.reshape(b, n_chunks, -1)[:, 0]   # first chunk's EOT pool
        return cond, pooled

    def _embeds_with_fixes(self, tokens, fixes_per_row):
        """The token embeddings with each row's embedding vectors written
        over their placeholder tokens (clip.py:98-118; chunk position + 1
        for BOS), or None when no row has any."""
        if not any(fixes_per_row):
            return None
        x = self.model.embeddings["token_embedding"](tokens)
        for i, fixes in enumerate(fixes_per_row):
            for pos, emb in fixes:
                vec = getattr(emb, self.embedding_field)[:, : x.shape[-1]]
                x[i, pos + 1: pos + 1 + emb.vectors] = vec.to(x.device, x.dtype)
        return x


def build_cond_schedule(encode_fn: Callable, prompt: str, negative_prompt: str,
                        steps: int, cond_scale: float = 7.5,
                        vector_maker: Callable | None = None,
                        hires_steps: int | None = None,
                        use_old_scheduling: bool = False) -> CondSchedule:
    """Parse prompt-edit/AND syntax, encode every unique schedule text once,
    assemble the banks and per-step index tables (conditioner.py:272-352).

    encode_fn(list_of_texts) -> (N, S, D) conds, or (conds, pooled (N, Dp))
    for SDXL.  vector_maker(pooled, is_uncond (N,) bool) -> (N, D_adm)
    builds the SDXL y vectors, banked like the conds.  hires_steps: the
    hires pass's steps; its tables continue the first pass's schedule over
    them, unless use_old_scheduling (conditioner.py:276-297)."""
    subprompts = prompt_parser.split_multicond(prompt)
    k = len(subprompts)
    pos_scheds = [prompt_parser.get_prompt_schedule(
        sp.text, steps, hires_steps, use_old_scheduling) for sp in subprompts]
    neg_sched = prompt_parser.get_prompt_schedule(
        negative_prompt, steps, hires_steps, use_old_scheduling)
    if hires_steps is not None and not use_old_scheduling:
        steps = hires_steps

    texts = [t for sched in pos_scheds for _, t in sched] + [t for _, t in neg_sched]
    conds = encode_fn(texts)          # (total, S, D), one batch: chunk counts match
    pooled = None
    if isinstance(conds, tuple):
        conds, pooled = conds

    max_sched = max(max(len(s) for s in pos_scheds), 1)
    row_ids = np.zeros((k, max_sched), np.int64)
    cond_idx = np.zeros((k, steps), np.int64)
    ptr = 0
    for ki, sched in enumerate(pos_scheds):
        for si in range(max_sched):
            row_ids[ki, si] = ptr + min(si, len(sched) - 1)
        ptr += len(sched)
        # per-step entry: first schedule item with end_at_step >= step (1-based)
        si = 0
        for step in range(1, steps + 1):
            while si < len(sched) - 1 and sched[si][0] < step:
                si += 1
            cond_idx[ki, step - 1] = si
    rows = torch.as_tensor(row_ids, device=conds.device)
    cond_bank = conds[rows]

    n_u = len(neg_sched)
    uncond_bank = conds[ptr: ptr + n_u]
    uncond_idx = np.zeros((steps,), np.int64)
    si = 0
    for step in range(1, steps + 1):
        while si < n_u - 1 and neg_sched[si][0] < step:
            si += 1
        uncond_idx[step - 1] = si

    vector_bank = vector_uncond_bank = None
    if pooled is not None and vector_maker is not None:
        is_uncond = torch.zeros(pooled.shape[0], dtype=torch.bool, device=pooled.device)
        is_uncond[ptr:] = True
        vectors = vector_maker(pooled, is_uncond)       # (total, D_adm)
        vector_bank = vectors[rows]
        vector_uncond_bank = vectors[ptr: ptr + n_u]

    return CondSchedule(
        cond_bank=cond_bank, cond_idx=cond_idx,
        cond_weights=np.asarray([sp.weight for sp in subprompts], np.float32),
        uncond_bank=uncond_bank, uncond_idx=uncond_idx, cond_scale=cond_scale,
        vector_bank=vector_bank, vector_uncond_bank=vector_uncond_bank)
