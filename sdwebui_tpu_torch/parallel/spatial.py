"""Row-sharded (context-parallel) VAE decode and encode.

Port of ``sdwebui_tpu/parallel/spatial.py``.  The image's rows shard over
the runtime's ``data`` axis: each shard decodes (encodes) its slice of the
latent (image) rows on its data shard's device, on a thread of its own,
inside ``collectives.spatial_sharding``: every stride-1 3×3 conv exchanges
one boundary row with its neighbours, GroupNorm sums its statistics over
the shards and the mid-block attention all-gathers k and v
(``models/vae``), so the sharded result equals the one-device call to
float tolerance while each shard holds 1/n of the activations.  The
shards' rows are concatenated on the latent's device.

Both fall back to the plain call when the data axis has one shard, when
the rows do not divide it, and for a tiling (wrap-padded) decode, whose
wrap is the whole image's: JAX's wraps each shard on its own.
"""

from __future__ import annotations

import torch

from sdwebui_tpu_torch.parallel import collectives
from sdwebui_tpu_torch.parallel.mesh import (DATA_AXIS, MeshRuntime, data_group, get_runtime,
                                             on_device)


def _run_rows(module_fn, vae, x, rt: MeshRuntime) -> torch.Tensor:
    group = data_group(rt)
    parts = [p.to(dev, copy=True) for p, dev in zip(x.chunk(rt.data_size, dim=2),
                                                     rt.data_devices)]

    def shard(rank):
        with collectives.spatial_sharding(DATA_AXIS):
            return module_fn(on_device(vae, group.devices[rank]), parts[rank])

    return torch.cat([o.to(x.device) for o in group.run(shard)], dim=2)


def decode_spatial(vae, latents: torch.Tensor, rt: MeshRuntime | None = None,
                   tiling: bool = False) -> torch.Tensor:
    """Latents (B, z, h, w) → images (B, 3, 8h, 8w), rows sharded over `data`."""
    rt = rt or get_runtime()
    n = rt.data_size
    if n <= 1 or latents.shape[2] % n or tiling:
        return vae.decode(latents, tiling=tiling)
    return _run_rows(lambda v, z: v.decode(z), vae, latents, rt)


def encode_spatial(vae, images: torch.Tensor, rt: MeshRuntime | None = None) -> torch.Tensor:
    """Images (B, 3, H, W) → moments (B, 2z, H/8, W/8), rows sharded over `data`."""
    rt = rt or get_runtime()
    n = rt.data_size
    if n <= 1 or images.shape[2] % (8 * n):
        return vae.encode_moments(images)
    return _run_rows(lambda v, x: v.encode_moments(x), vae, images, rt)
