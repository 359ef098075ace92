"""Sequence (context) parallelism: ring attention over a one-axis group.

Port of ``sdwebui_tpu/parallel/sequence.py``.  The token axis of
(B, H, S, D) q, k and v splits over the group's shards; each shard keeps
its q and an online-softmax carry in fp32 while the k and v blocks rotate
around the ring (shard j hands its block to j + 1, JAX's ``perm``), so no
shard holds the whole K/V or the whole score matrix (Liu et al. 2023,
"Ring Attention").  The recurrence is plain torch, as JAX's is ``jnp``:
no kernel of the port runs it.  The shards' outputs are concatenated on
q's device.
"""

from __future__ import annotations

import torch

from sdwebui_tpu_torch.parallel import collectives
from sdwebui_tpu_torch.parallel.mesh import MeshRuntime, visible_cards

SEQ_AXIS = "seq"


def _ring_local(q, k, v, scale: float):
    """One shard's body: q stays put, k and v visit every shard once."""
    n = collectives.axis_size(SEQ_AXIS)
    perm = [(j, (j + 1) % n) for j in range(n)]
    qf = q.float()
    m = torch.full(q.shape[:-1], -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for step in range(n):
        s = (qf @ k.float().transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + (p.to(v.dtype) @ v).float()
        m = m_new
        if step + 1 < n:     # JAX's last rotation returns k and v home unread
            k = collectives.ppermute(k, SEQ_AXIS, perm)
            v = collectives.ppermute(v, SEQ_AXIS, perm)
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)


def seq_mesh(n: int | None = None, devices=None) -> collectives.Group:
    """A one-axis ``seq`` group over n devices: the first n of `devices`
    (default every visible card; a device may repeat)."""
    devs = list(devices) if devices is not None else visible_cards()
    devs = devs[:n] if n else devs
    return collectives.Group(SEQ_AXIS, devs)


def ring_attention(q, k, v, group, scale: float | None = None):
    """q, k, v: (B, H, S, D) with S divisible by the group's size; `group`
    is a :func:`seq_mesh` or a MeshRuntime (its data axis).  Returns the
    whole (B, H, S, D) output."""
    if isinstance(group, MeshRuntime):
        group = collectives.Group(SEQ_AXIS, group.data_devices)
    n = group.size
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.shape[2] % n:
        raise ValueError(f"sequence {q.shape[2]} does not divide the ring of {n}")
    shards = [[t.to(dev, copy=True) for t, dev in zip(x.chunk(n, dim=2), group.devices)]
              for x in (q, k, v)]
    outs = group.run(lambda r: _ring_local(shards[0][r], shards[1][r], shards[2][r], scale))
    return torch.cat([o.to(q.device) for o in outs], dim=2)
