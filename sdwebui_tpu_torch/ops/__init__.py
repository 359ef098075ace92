"""The kernels' wrappers (attention, LayerNorm, 3×3 conv) and their dispatch."""

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """The hand-written kernels have no backward: a CUDA call whose result
    would need a gradient raises here rather than return a tensor with no
    ``grad_fn``.  Training runs its forward under
    ``training.step.training_ctx``, which takes the plain paths."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: a tensor that requires grad reached the "
                           "CUDA kernel (run the forward under training.step.training_ctx, "
                           "or without grad)")
