"""Attention dispatch: the flash kernel for long KV on CUDA, plain otherwise.

Port of ``sdwebui_tpu/ops/attention.py``.  Model code calls
:func:`attention`; the implementation is picked per call from the tensor's
device, the KV length and the head geometry (the TPU rules,
``attention.py:77-96,116-136``):

- (B, S, H·D) calls with Skv >= 1024 whose heads the JAX package would
  pack (:func:`packs_heads`) go to ``flash_attention_packed`` on CUDA,
  with no head split or merge copy;
- every other call is split into (B·H, S, D) heads, and those with
  Skv >= 1024 go to ``flash_attention`` on CUDA;
- the rest, and everything on the CPU, take :func:`plain_attention`.

``set_attention_impl`` / ``forced_impl`` override the choice with
``"flash"``, ``"flash-packed"`` or ``"plain"`` (None = automatic).
"""

from __future__ import annotations

import contextlib
import math

import torch

from sdwebui_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_packed)

_IMPLS = (None, "flash", "flash-packed", "plain")
_FORCED: str | None = None

#: KV length from which the kernel is used automatically
FLASH_MIN_KV = 1024


def set_attention_impl(name: str | None) -> None:
    if name not in _IMPLS:
        raise ValueError(f"unknown attention impl {name!r}; one of {_IMPLS}")
    global _FORCED
    _FORCED = name


def get_forced_impl() -> str | None:
    return _FORCED


@contextlib.contextmanager
def forced_impl(name: str | None):
    """Force an implementation for the calls made inside the block."""
    global _FORCED
    prev = _FORCED
    set_attention_impl(name)
    try:
        yield
    finally:
        _FORCED = prev


def packs_heads(head_dim: int, num_heads: int) -> bool:
    """The JAX package's auto rule for its packed kernel,
    ``packed_heads_per_block(d, H) <= 2`` (``attention.py:77-85``), restated
    without the 128-lane arithmetic: d a multiple of 128, or of 64 with an
    even head count.  In the repo's models that is d = 64 (SD2, SDXL)."""
    return head_dim % 128 == 0 or (head_dim % 64 == 0 and num_heads % 2 == 0)


def _require_cuda(device: torch.device):
    if device.type != "cuda":
        raise ValueError(f"attention impl {_FORCED!r} was forced, but the "
                         f"tensors are on {device}: the kernel needs CUDA")


def _use_packed(head_dim: int, num_heads: int, skv: int, device: torch.device) -> bool:
    if _FORCED == "flash-packed":
        _require_cuda(device)
        return True
    if _FORCED is not None:
        return False
    return device.type == "cuda" and skv >= FLASH_MIN_KV and packs_heads(head_dim, num_heads)


def _use_flash(skv: int, device: torch.device) -> bool:
    if _FORCED == "flash":
        _require_cuda(device)
        return True
    if _FORCED == "plain":
        return False
    return device.type == "cuda" and skv >= FLASH_MIN_KV


def plain_attention(q, k, v, scale=None):
    """Plain attention for short KV (77-token cross-attention) and the CPU:
    fp32 scores and softmax, p in q's dtype, p·v in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def attention(q, k, v, num_heads: int | None = None, scale=None):
    """Multi-head attention on (B, S, H*D) or (BH, S, D) tensors.

    If ``num_heads`` is given, inputs are (B, S, H*D): the packed kernel,
    or split → attend → merge.  Otherwise inputs are already (BH, S, D).
    """
    if num_heads is not None:
        b, sq, hd = q.shape
        skv = k.shape[1]
        d = hd // num_heads
        if _use_packed(d, num_heads, skv, q.device):
            return flash_attention_packed(q, k, v, num_heads=num_heads, scale=scale)

        def split(t, s):
            return t.reshape(b, s, num_heads, d).transpose(1, 2).reshape(b * num_heads, s, d)

        out = attention(split(q, sq), split(k, skv), split(v, skv), scale=scale)
        return out.reshape(b, num_heads, sq, d).transpose(1, 2).reshape(b, sq, hd)
    if _use_flash(k.shape[1], q.device):
        return flash_attention(q, k, v, scale=scale)
    return plain_attention(q, k, v, scale=scale)
