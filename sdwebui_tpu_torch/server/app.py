"""Server application state: the models, the queue lock and the job state.

Port of ``sdwebui_tpu/server/app.py:24-380`` (txt2img, img2img and the
checkpoint half).  An ``Engine`` serves either checkpoint files — a
``CheckpointRegistry`` over the checkpoint directories, the first model
loaded when first needed, ``reload_checkpoint`` with the
``sd_checkpoints_limit`` LRU of resident models (the displaced one parked
in host RAM with ``sd_checkpoints_keep_in_cpu``), per-request checkpoint
and VAE switching through ``override_settings``, and refiners found
through the registry — or, when asked for, random weights at full width
(SD1.5, or the SDXL base with a resident refiner) or the tiny test models.
Generations and Extras upscales run one at a time under the queue lock,
which model switches take too, with the job's progress in a
``runtime.state.State``.  The upscalers are the process's registry
(``postprocessing/upscalers``), which ``server/__main__`` fills from the
ESRGAN and Real-ESRGAN directories at start (JAX's app.py:44-57); so are
the LoRA, hypernetwork and ControlNet registries.  Every model the Engine
loads or is given gets a textual-inversion database of the embeddings
directory (app.py:143-154).  A request's LoRA set runs on a merged copy
that the base model caches and drops whenever it moves
(``networks/extra_networks``): the live, parked and cached models are
always the checkpoints' own weights.

Unlike JAX (``app.py:208-226``), a checkpoint load that fails leaves the
resident models as they were: the live model is moved back, and no parked
duplicate of it stays in the cache.
"""

from __future__ import annotations

import os
import threading

from sdwebui_tpu_torch.loader import load
from sdwebui_tpu_torch.loader.registry import CheckpointRegistry, file_sha256
from sdwebui_tpu_torch.networks.textual_inversion import (DEFAULT_EMBEDDINGS_DIR,
                                                          attach_embeddings)
from sdwebui_tpu_torch.ops.attention import set_attention_impl
from sdwebui_tpu_torch.pipeline.img2img import process_img2img
from sdwebui_tpu_torch.pipeline.params import GenerationParams, Processed
from sdwebui_tpu_torch.pipeline.processing import process_txt2img, uses_refiner
from sdwebui_tpu_torch.pipeline.sd_model import (SDModel, create_random_sd15,
                                                 create_random_sdxl,
                                                 create_tiny_sd,
                                                 create_tiny_sdxl)
from sdwebui_tpu_torch.postprocessing.stages import StageArgs, run_stages
from sdwebui_tpu_torch.runtime.state import State
from sdwebui_tpu_torch.text.styles import StyleDatabase
from sdwebui_tpu_torch.utils.devices import get_device
from sdwebui_tpu_torch.utils.options import opts

#: opts.cross_attention_optimization → attention impl
ATTENTION_IMPLS = {"Automatic": None, "flash": "flash", "flash-packed": "flash-packed",
                   "plain": "plain"}

#: seed offset of the random SDXL refiner (the JAX bench's 100 for base 0)
REFINER_SEED_OFFSET = 100

#: where checkpoints, VAEs and the hash cache live unless the caller says
#: otherwise (the reference's layout, relative to the working directory)
DEFAULT_CKPT_DIR = os.path.join("models", "Stable-diffusion")
DEFAULT_VAE_DIR = os.path.join("models", "VAE")
DEFAULT_HASH_CACHE = "cache.json"
DEFAULT_STYLES = "styles.csv"


class CheckpointNotFound(LookupError):
    """A checkpoint or refiner name the registry does not hold."""


def random_models(family: str, device, tiny: bool = False, seed: int = 0):
    """(base, extra models by title) for the random-weight mode: SD1.5, or
    the SDXL base with its refiner, which shares the base's bigG and VAE
    (bench.py:474-477)."""
    if family == "sd15":
        return (create_tiny_sd if tiny else create_random_sd15)(seed, device), {}
    if family != "sdxl":
        raise ValueError(f"unknown model family {family!r} (sd15 or sdxl)")
    make = create_tiny_sdxl if tiny else create_random_sdxl
    base = make(seed, device)
    refiner = make(seed + REFINER_SEED_OFFSET, device, refiner=True, shared=base)
    return base, {refiner.title: refiner}


class Engine:
    """model: serve this model; else ckpt / ckpt_dirs: serve checkpoint
    files (ckpt, a path or a registry name, is loaded first; without it
    opts.sd_model_checkpoint, then the first file found); else random
    weights of `family`.  vae_path: one VAE file for every checkpoint
    (the sd_vae setting is then not read); hash_cache: the sha256 cache
    file (None: no cache); embeddings_dir: the textual-inversion files;
    styles_path: the prompt styles' CSV."""

    def __init__(self, device="cuda", tiny: bool = False, seed: int = 0,
                 model: SDModel | None = None, family: str = "sd15",
                 extra_models: dict[str, SDModel] | None = None,
                 ckpt: str | None = None, ckpt_dirs=None, vae_path: str | None = None,
                 vae_dirs=(DEFAULT_VAE_DIR,), hash_cache: str | None = DEFAULT_HASH_CACHE,
                 embeddings_dir: str = DEFAULT_EMBEDDINGS_DIR,
                 styles_path: str = DEFAULT_STYLES):
        self.device = get_device(device)
        self.embeddings_dir = embeddings_dir
        self.styles = StyleDatabase(styles_path)
        self.queue_lock = threading.RLock()
        self.state = State()
        self.vae_path, self.vae_dirs, self.hash_cache = vae_path, tuple(vae_dirs), hash_cache
        self.registry, self._requested_ckpt = None, None
        self._model, self._model_key = model, None
        self._cache: dict[str, SDModel] = {}        # displaced checkpoints by name
        self._extra_models = dict(extra_models or {})
        if model is None and ckpt is None and not ckpt_dirs:
            self._model, made = random_models(family, self.device, tiny, seed)
            self._extra_models.update(made)
        elif model is None:
            dirs = [os.path.abspath(d) for d in (ckpt_dirs or [DEFAULT_CKPT_DIR])]
            if ckpt and os.path.isfile(ckpt):
                # a file outside the directories is served from its own
                home = os.path.dirname(os.path.abspath(ckpt))
                dirs += [] if home in dirs else [home]
                ckpt = os.path.relpath(os.path.abspath(ckpt), next(
                    d for d in dirs if os.path.abspath(ckpt).startswith(d + os.sep)))
            self.registry = CheckpointRegistry(dirs, cache_path=hash_cache)
            if ckpt and self.registry.find(ckpt) is None:
                raise FileNotFoundError(f"checkpoint {ckpt!r} is neither a file nor in "
                                        f"{self.registry.model_dirs}")
            self._requested_ckpt = ckpt
        if self._model is not None:
            attach_embeddings(self._model, self.embeddings_dir)

    # ---- model lifecycle ----------------------------------------------

    @property
    def sd_model(self) -> SDModel:
        """The live model, loading the first checkpoint when none is."""
        with self.queue_lock:
            if self._model is None:
                info = self._find(self._requested_ckpt or opts.get("sd_model_checkpoint"))
                self._model, self._model_key = self._load(info), info.name
            return self._model

    def _find(self, name, what: str = "checkpoint"):
        info = self.registry.find(name) if self.registry is not None else None
        if info is None:
            where = self.registry.model_dirs if self.registry is not None else \
                "the resident models (no checkpoint directory is served)"
            raise CheckpointNotFound(f"{what} {name!r} not found in {where}" if name
                                     else f"no checkpoint file in {where}")
        return info

    def _load(self, info) -> SDModel:
        """A checkpoint file with its VAE (the sd_vae chain or vae_path)."""
        model = load.load_model(info.filename, title=info.name,
                                sha256=info.calculate_sha256(self.hash_cache),
                                device=self.device)
        opts.data["sd_checkpoint_hash"] = model.sha256
        self._set_vae(model, self.vae_path or load.resolve_vae(info.filename, self.vae_dirs))
        attach_embeddings(model, self.embeddings_dir)
        return model

    def refresh_embeddings(self):
        """Scan the embeddings directory into a new database of the live
        model (api.py:905)."""
        with self.queue_lock:
            attach_embeddings(self.sd_model, self.embeddings_dir)

    def reload_checkpoint(self, name: str | None = None):
        """Make `name` (default opts.sd_model_checkpoint) the live model: from
        the resident cache, or loaded from its file; the displaced model
        joins the cache, parked in host RAM with sd_checkpoints_keep_in_cpu,
        and the cache keeps sd_checkpoints_limit - 1 models."""
        with self.queue_lock:
            info = self._find(name or opts.get("sd_model_checkpoint"))
            if self._model is not None and info.name == self._model_key:
                return
            prev, prev_key = self._model, self._model_key
            if prev is not None:
                if opts.get("sd_checkpoints_keep_in_cpu", True):
                    prev.to("cpu")
                self._cache[prev_key] = prev
            try:
                model = self._cache.pop(info.name, None)
                model = self._load(info) if model is None else model.to(self.device)
            except BaseException:
                if prev is not None:        # the live model stays, no duplicate
                    self._cache.pop(prev_key)
                    prev.to(self.device)
                raise
            self._model, self._model_key = model, info.name
            limit = max(int(opts.get("sd_checkpoints_limit", 1)) - 1, 0)
            while len(self._cache) > limit:
                self._cache.pop(next(iter(self._cache)))

    def unload_checkpoint(self):
        """Drop the live model; the next request loads the first one again."""
        with self.queue_lock:
            if self.registry is None:
                raise CheckpointNotFound("random-weight models cannot be reloaded from a file")
            self._model, self._model_key = None, None

    # ---- VAE ------------------------------------------------------------

    def _set_vae(self, model: SDModel, path: str | None):
        """Give `model` the VAE file at `path`, or back its own with None."""
        if (path or "") == model.vae_file:
            return
        if model.embedded_vae is None:
            model.embedded_vae = model.vae
        if path is None:
            model.vae, model.vae_cfg = model.embedded_vae, model.embedded_vae.cfg
            model.embedded_vae, model.vae_file, model.vae_sha256 = None, "", ""
            return
        model.vae, model.vae_cfg = load.load_external_vae(
            path, self.device, scale_factor=model.vae_cfg.scale_factor)
        model.vae_file, model.vae_sha256 = path, file_sha256(path, self.hash_cache)

    def _maybe_switch(self, p: GenerationParams):
        """override_settings.sd_model_checkpoint / sd_vae of one request
        (app.py:238-280); the switch lasts past the request, as in JAX."""
        want = (p.override_settings or {}).get("sd_model_checkpoint")
        if want and (self.registry is not None or want != self._model.title):
            self.reload_checkpoint(self._find(want, "sd_model_checkpoint").name)
        if self.registry is not None and not self.vae_path:
            model = self.sd_model
            with opts.override({"sd_vae": (p.override_settings or {}).get(
                    "sd_vae", opts.get("sd_vae", "Automatic"))}):
                self._set_vae(model, load.resolve_vae(model.filename, self.vae_dirs))

    # ---- generation ----------------------------------------------------

    def _resolve_refiner(self, p: GenerationParams) -> SDModel | None:
        """The model a request names as its refiner (app.py:343-361): a
        resident one, else loaded through the registry; at most two stay."""
        if not uses_refiner(p):
            return None
        model = self._extra_models.get(p.refiner_checkpoint)
        if model is None:
            info = self._find(p.refiner_checkpoint, "refiner_checkpoint")
            model = load.load_model(info.filename, title=info.name,
                                    sha256=info.calculate_sha256(self.hash_cache),
                                    device=self.device)
            if len(self._extra_models) >= 2:
                self._extra_models.clear()
            self._extra_models[p.refiner_checkpoint] = model
        return model

    def _apply_runtime_opts(self):
        """Push live settings into every resident model's conditioners and
        the attention dispatch (app.py:73-94)."""
        for model in (self.sd_model, *self._extra_models.values()):
            for cond in (model.conditioner, model.conditioner2):
                if cond is not None:
                    cond.emphasis = (opts.get("emphasis", "Original")
                                     if opts.get("enable_emphasis", True) else "None")
                    cond.comma_padding_backtrack = opts.get("comma_padding_backtrack", 20)
        impl = opts.get("cross_attention_optimization", "Automatic")
        if impl not in ATTENTION_IMPLS:
            raise NotImplementedError(
                f"cross_attention_optimization {impl!r} is not ported "
                f"(one of {sorted(ATTENTION_IMPLS)})")
        set_attention_impl(ATTENTION_IMPLS[impl])

    def _step_callback(self, i: int, n: int, latents) -> bool:
        self.state.sampling_step = i + 1
        self.state.sampling_steps = n
        return not (self.state.interrupted or self.state.skipped)

    def apply_styles(self, p: GenerationParams):
        """The request's styles merged into its prompts (app.py:68-71)."""
        if p.styles:
            p.prompt, p.negative_prompt = self.styles.apply(p.prompt, p.negative_prompt,
                                                            p.styles)

    def _run(self, job: str, p: GenerationParams, fn) -> Processed:
        """One generation under the queue lock, with the job state set and
        the request's styles applied."""
        self.apply_styles(p)
        with self.queue_lock:
            self._maybe_switch(p)
            with opts.override(p.override_settings):
                self._apply_runtime_opts()
            self.state.begin(job)
            self.state.job_count = p.n_iter
            try:
                return fn()
            finally:
                self.state.end()

    def txt2img(self, p: GenerationParams) -> Processed:
        return self._run("txt2img", p, lambda: process_txt2img(
            self.sd_model, p, step_callback=self._step_callback,
            refiner_model=self._resolve_refiner(p), interrupted=self._interrupted))

    def extras(self, images: list, args: StageArgs) -> list:
        """The Extras stage chain over RGB uint8 images, one job."""
        with self.queue_lock:
            self.state.begin("extras")
            self.state.job_count = len(images)
            try:
                return [run_stages(im, args) for im in images]
            finally:
                self.state.end()

    def _interrupted(self) -> bool:
        return self.state.interrupted

    def img2img(self, p: GenerationParams) -> Processed:
        """app.py:363-379: img2img and inpainting on the live model (an SDXL
        base or its 9-channel inpainting variant too)."""
        return self._run("img2img", p, lambda: process_img2img(
            self.sd_model, p, step_callback=self._step_callback,
            interrupted=self._interrupted))
