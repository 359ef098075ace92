"""Attention dispatch: the flash kernels for long KV on CUDA, plain otherwise.

Port of ``sdwebui_tpu/ops/attention.py``.  Model code calls
:func:`attention`; the implementation is picked per call from the tensor's
device and the KV length (the TPU rule, ``attention.py:116-136``):

- (B, S, H·D) calls with Skv >= 1024 go to ``flash_attention_packed`` on
  CUDA, whatever the head dim: the kernel reads each head through the
  strides, so no head split or merge copy is made (the JAX package's
  128-lane packing rule has no counterpart on the card);
- (BH, S, D) calls with Skv >= 1024 (the VAE's single head) go to
  ``flash_attention`` on CUDA;
- the rest, and everything on the CPU, take :func:`plain_attention`.

``set_attention_impl`` / ``forced_impl`` override the choice: ``"flash"``
and ``"flash-packed"`` (the names the JAX package and the server accept)
both force the kernels, ``"plain"`` the plain path, None is automatic.
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


def _use_flash(skv: int, device: torch.device) -> bool:
    if _FORCED in ("flash", "flash-packed"):
        if device.type != "cuda":
            raise ValueError(f"attention impl {_FORCED!r} was forced, but the "
                             f"tensors are on {device}: the kernel needs CUDA")
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
    or split → plain → merge.  Otherwise inputs are already (BH, S, D).
    """
    use_flash = _use_flash(k.shape[1], q.device)
    if num_heads is None:
        if use_flash:
            return flash_attention(q, k, v, scale=scale)
        return plain_attention(q, k, v, scale=scale)
    if use_flash:
        return flash_attention_packed(q, k, v, num_heads=num_heads, scale=scale)
    b, sq, hd = q.shape
    d = hd // num_heads

    def split(t):
        return t.reshape(b, t.shape[1], num_heads, d).transpose(1, 2).reshape(
            b * num_heads, t.shape[1], d)

    out = plain_attention(split(q), split(k), split(v), scale=scale)
    return out.reshape(b, num_heads, sq, d).transpose(1, 2).reshape(b, sq, hd)
