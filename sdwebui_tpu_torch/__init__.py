"""sdwebui_tpu_torch — the PyTorch/CUDA port of ``sdwebui_tpu``.

Mirrors the JAX package's module layout (``ops/``, ``models/``, ``text/``,
``sampling/``, ``pipeline/``, ``server/``, ``utils/``) so each module's
counterpart is found by path.  Modules compute in NCHW with ``nn.Module``
parameters named as the ldm/HF state-dict keys; the TPU's Pallas kernels
become hand-written CUDA kernels under ``csrc/`` (built with nvcc at first
use).  The package imports torch and never jax; the jax-free host modules
of ``sdwebui_tpu`` (tokenizer, prompt parser, Philox RNG, params, options,
infotext) are reused as they are.
"""

__version__ = "0.1.0"
