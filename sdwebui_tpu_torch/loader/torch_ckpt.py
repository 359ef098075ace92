"""``.ckpt`` / ``.pt`` checkpoints through torch's restricted unpickler.

Port of ``sdwebui_tpu/loader/torch_ckpt.py:35-158``.  The file is loaded
with ``torch.load(weights_only=True, mmap=True)``, whose unpickler builds
only tensors and plain containers; the extra globals it may resolve are
the JAX package's allowlist (``torch_ckpt.py:80-87``): numpy's scalar and
``numpy.dtype`` and ``_codecs.encode``, which SD checkpoints use for their
step counters.  Any other global raises ``pickle.UnpicklingError``.
``mmap=True`` needs torch's zip format, the only one the JAX reader takes
too; a legacy file raises naming the format.
"""

from __future__ import annotations

import codecs
import zipfile

import numpy as np
import torch


def _allowed_globals() -> list:
    """The allowed globals, each as (object, the name a checkpoint's pickle
    gives it), plus the classes numpy.dtype builds its instances in
    (numpy >= 1.25), so that the unpickler may apply a dtype's pickled
    state; no pickle names those."""
    try:
        from numpy._core.multiarray import scalar       # numpy >= 2
    except ImportError:
        from numpy.core.multiarray import scalar        # numpy 1.x
    dtype_classes = {type(np.dtype(c)) for c in "?bBhHiIlLqQefd"} - {np.dtype}
    return [(scalar, "numpy.core.multiarray.scalar"), (np.dtype, "numpy.dtype"),
            (codecs.encode, "_codecs.encode"), *sorted(dtype_classes, key=str)]


def load_torch_object(path: str):
    """.pt/.ckpt (torch's zip format) → the object it holds, through the
    restricted unpickler."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is a legacy (non-zip) torch checkpoint; only torch's zip "
                         "format (torch.save since torch 1.6) is read")
    with torch.serialization.safe_globals(_allowed_globals()):
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def load_torch_checkpoint(path: str) -> dict:
    """.pt/.ckpt (torch's zip format) → {key: tensor}: the ``state_dict``
    when the file wraps one, nested dicts flattened with dotted keys,
    entries other than tensors dropped."""
    obj = load_torch_object(path)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    if not isinstance(sd, dict):
        raise ValueError(f"unexpected checkpoint structure in {path}")
    out = {}

    def collect(d: dict, prefix: str):
        for k, v in d.items():
            if isinstance(v, torch.Tensor):
                out[f"{prefix}{k}"] = v
            elif isinstance(v, dict):
                collect(v, f"{prefix}{k}.")

    collect(sd, "")
    return out
