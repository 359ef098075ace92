"""Checkpoint discovery (reference modules/sd_models.py:56-180): the
``.safetensors`` / ``.ckpt`` / ``.pt`` files under the model directories,
their sha256 (computed lazily, cached in a JSON file keyed by path, mtime
and size), titles, and lookup by title, name or hash.

Port of ``sdwebui_tpu/loader/registry.py:15-110``.  The hash cache lives
where the caller says (``cache_path``); None keeps no cache.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os

from sdwebui_tpu_torch.utils.options import opts


@dataclasses.dataclass
class CheckpointInfo:
    filename: str
    name: str
    sha256: str | None = None

    @property
    def title(self) -> str:
        if self.sha256:
            return f"{self.name} [{self.sha256[:10]}]"
        return self.name

    @property
    def model_name(self) -> str:
        return os.path.splitext(self.name)[0]

    def calculate_sha256(self, cache_path: str | None = None) -> str:
        if not self.sha256:
            self.sha256 = file_sha256(self.filename, cache_path)
        return self.sha256


def file_sha256(path: str, cache_path: str | None = None) -> str:
    """sha256 of a file, with the mtime+size-keyed JSON cache at
    `cache_path` (reference modules/hashes.py sha256 + cache.json)."""
    cache = {}
    if cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
        except (OSError, ValueError):
            cache = {}
    st = os.stat(path)
    cache_key = f"{path}:{st.st_mtime}:{st.st_size}"
    if cache_key in cache:
        return cache[cache_key]
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    digest = h.hexdigest()
    if cache_path:
        cache[cache_key] = digest
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        with open(cache_path, "w") as f:
            json.dump(cache, f)
    return digest


def _visible(path: str) -> bool:
    """opts.list_hidden_files off hides files under dot-directories
    (reference modules/util.py:48)."""
    if opts.get("list_hidden_files", True):
        return True
    parts = os.path.normpath(os.path.dirname(path)).split(os.sep)
    return not any(p.startswith(".") and p not in (".", "..") for p in parts)


class CheckpointRegistry:
    def __init__(self, model_dirs: list[str], cache_path: str | None = None):
        self.model_dirs = model_dirs
        self.cache_path = cache_path
        self.checkpoints: dict[str, CheckpointInfo] = {}
        self.refresh()

    def refresh(self):
        self.checkpoints = {}
        for d in self.model_dirs:
            if not os.path.isdir(d):
                continue
            for ext in ("*.safetensors", "*.ckpt", "*.pt"):
                for path in sorted(glob.glob(os.path.join(d, "**", ext), recursive=True,
                                             include_hidden=True)):
                    if ".vae." in os.path.basename(path).lower() or not _visible(path):
                        continue   # sibling VAE files are not checkpoints
                    name = os.path.relpath(path, d)
                    self.checkpoints[name] = CheckpointInfo(path, name)

    def list(self) -> list[CheckpointInfo]:
        return list(self.checkpoints.values())

    def find(self, name_or_title: str | None) -> CheckpointInfo | None:
        """By name, title or model name; the first checkpoint for None."""
        if not name_or_title:
            return next(iter(self.checkpoints.values()), None)
        base = name_or_title.split(" [")[0]
        for info in self.checkpoints.values():
            if name_or_title in (info.name, info.title, info.model_name) \
                    or base in (info.name, info.model_name):
                return info
        if "[" in name_or_title:           # by hash
            h = name_or_title.split("[")[1].rstrip("]")
            for info in self.checkpoints.values():
                if info.sha256 and info.sha256.startswith(h):
                    return info
        return None
