"""Token merging (ToMe for SD): port of ``sdwebui_tpu/ops/tome.py:23-94``.

Splits the h×w token grid into dst tokens (the top-left of every sx×sy
block) and src tokens (the rest), finds each src token's most similar dst
by cosine similarity, merges the r = int(N·ratio) most similar src tokens
into their dst by a scatter-mean (the dst's own value included), runs the
attention on the reduced set and unmerges: a merged position reads its
dst's output.  dst selection has no randomness (tomesd's no_rand mode, as
in the JAX package).  Ties in the similarity order resolve as JAX's stable
``argsort`` does (``stable=True``).
"""

from __future__ import annotations

import numpy as np
import torch


def _grid_split(h: int, w: int, sx: int = 2, sy: int = 2):
    """(dst_pos, src_pos) index arrays over the flat h·w grid."""
    ys, xs = np.meshgrid(np.arange(0, h, sy), np.arange(0, w, sx), indexing="ij")
    dst = (ys * w + xs).reshape(-1)
    mask = np.ones(h * w, bool)
    mask[dst] = False
    return dst, np.nonzero(mask)[0]


def merged_tokens(h: int, w: int, ratio: float, sx: int = 2, sy: int = 2) -> int:
    """Tokens left after merging an h×w grid (h·w when nothing merges)."""
    n = h * w
    if h % sy or w % sx:
        return n
    r = min(int(n * ratio), n - (h // sy) * (w // sx))
    return n - r if r > 0 else n


def build_merge(x, h: int, w: int, ratio: float, sx: int = 2, sy: int = 2):
    """(merge, unmerge, merged_len) for tokens x: (B, h·w, C), or None when
    the grid or the ratio makes merging a no-op.  The similarity runs in
    fp32 whatever x's dtype."""
    n = h * w
    if x.shape[1] != n or h % sy or w % sx:
        return None
    dst_np, src_np = _grid_split(h, w, sx, sy)
    r = min(int(n * ratio), len(src_np))
    if r <= 0:
        return None
    dst_pos = torch.as_tensor(dst_np, device=x.device)
    src_pos = torch.as_tensor(src_np, device=x.device)
    xf = x.float()
    metric = xf / xf.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    scores = metric[:, src_pos] @ metric[:, dst_pos].transpose(1, 2)   # (B, S, D)
    node_max, node_idx = scores.max(dim=-1)                           # best dst per src
    order = torch.argsort(-node_max, dim=-1, stable=True)              # most similar first
    merged_src, kept_src = order[:, :r], order[:, r:]
    tgt = node_idx.gather(1, merged_src)                               # (B, r)
    n_dst, s_kept = len(dst_np), len(src_np) - r
    b = x.shape[0]
    src_b = src_pos.expand(b, -1)
    kept_abs = src_b.gather(1, kept_src)
    merged_abs = src_b.gather(1, merged_src)

    def merge(t):
        c = t.shape[-1]
        tsrc, tdst = t[:, src_pos], t[:, dst_pos]
        kept = tsrc.gather(1, kept_src[..., None].expand(-1, -1, c))
        mvals = tsrc.gather(1, merged_src[..., None].expand(-1, -1, c))
        # scatter-mean with the dst's own value (tomesd mode="mean")
        summed = tdst.scatter_add(1, tgt[..., None].expand(-1, -1, c), mvals)
        counts = torch.ones((b, n_dst), dtype=t.dtype, device=t.device).scatter_add(
            1, tgt, torch.ones((b, r), dtype=t.dtype, device=t.device))
        return torch.cat([kept, summed / counts[..., None]], dim=1)   # (B, S-r+D, C)

    def unmerge(t):
        c = t.shape[-1]
        kept, tdst = t[:, :s_kept], t[:, s_kept:]
        out = t.new_zeros((b, n, c))
        out[:, dst_pos] = tdst
        out.scatter_(1, kept_abs[..., None].expand(-1, -1, c), kept)
        out.scatter_(1, merged_abs[..., None].expand(-1, -1, c),
                     tdst.gather(1, tgt[..., None].expand(-1, -1, c)))
        return out

    return merge, unmerge, s_kept + n_dst
