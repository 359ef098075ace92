"""sdwebui_tpu_torch — the PyTorch/CUDA port of ``sdwebui_tpu``.

Mirrors the JAX package's module layout (``ops/``, ``models/``, ``text/``,
``sampling/``, ``pipeline/``, ``server/``, ``utils/``, ``rng/``,
``runtime/``) so each module's counterpart is found by path.  Modules
compute in NCHW with ``nn.Module`` parameters named as the ldm/HF
state-dict keys; the TPU's Pallas kernels become hand-written CUDA kernels
under ``csrc/`` (built with nvcc at first use).  The package imports torch,
numpy and the standard library, and nothing of jax or of ``sdwebui_tpu``:
the host modules it shares with the JAX package (tokenizer, prompt parser,
Philox RNG, params, options, infotext, configs, job state) are copies, each
naming its source.
"""

__version__ = "0.1.0"
