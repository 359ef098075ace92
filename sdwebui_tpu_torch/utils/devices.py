"""Device choice, dtype policy and the NaN check.

Port of ``sdwebui_tpu/utils/devices.py:42-118``.  Every model call takes an
explicit ``torch.device``; asking for CUDA on a machine without a card
raises instead of continuing on the CPU.
"""

from __future__ import annotations

import dataclasses
import os

import torch

# TF32 is off for both matmuls and cuDNN convolutions: PyTorch leaves
# matmul TF32 off by default but turns it ON for cuDNN f32 convolutions,
# which would cut the f32 VAE decode (the NaN retry) and every f32 parity
# check to ~3 decimal digits.  bf16 compute is unaffected.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def get_device(name: str | torch.device) -> torch.device:
    """The device for `name`; "cuda" without an available card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but torch.cuda.is_available() "
                           "is False")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


@dataclasses.dataclass
class DtypePolicy:
    """Explicit replacement for autocast (reference modules/devices.py:210).

    param_dtype:   storage dtype of the UNet weights
    compute_dtype: activation dtype inside the UNet
    vae_dtype:     VAE weights and the dtype of its fp32 retry decode; the
                   first decode runs in bf16 when opts.sdtpu_vae_bf16 is on
                   and retries in this dtype on NaN (processing.py:523-546)

    The fp32 islands are fixed, not a policy field: sigma/schedule math on
    the host, norm statistics, softmax and the kernel's accumulators.
    """

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    vae_dtype: torch.dtype = torch.float32


FP32_POLICY = DtypePolicy(torch.float32, torch.float32, torch.float32)

_policy = DtypePolicy()
if os.environ.get("SDTPU_FP32") == "1":  # full-precision escape hatch
    _policy = FP32_POLICY


def get_policy() -> DtypePolicy:
    return _policy


def set_policy(policy: DtypePolicy) -> None:
    global _policy
    _policy = policy


def all_finite(x: torch.Tensor) -> bool:
    """The NaN check: one scalar to the host.  inf counts as NaN, as in the
    bf16 VAE decode's retry flag (processing.py:342)."""
    return bool(torch.isfinite(x).all())
