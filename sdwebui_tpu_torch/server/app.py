"""Server application state: the models, the queue lock and the job state.

Port of ``sdwebui_tpu/server/app.py:24-409`` (txt2img, img2img, the
scripts and the checkpoint half).  An ``Engine`` serves either checkpoint files — a
``CheckpointRegistry`` over the checkpoint directories, the first model
loaded when first needed, ``reload_checkpoint`` with the
``sd_checkpoints_limit`` LRU of resident models (the displaced one parked
in host RAM with ``sd_checkpoints_keep_in_cpu``), per-request checkpoint
and VAE switching through ``override_settings``, and refiners found
through the registry — or, when asked for, random weights at full width
(SD1.5, or the SDXL base with a resident refiner) or the tiny test models.
Generations and Extras upscales run one at a time under the queue lock,
which model switches take too, with the job's progress in a
``runtime.state.State``: the sampler's step callback sets the step, stops
on an interrupt or a skip (a skip ends the batch in flight only) and makes
the live previews; the batch callback advances ``job_no`` and ends the job
before the next batch on an interrupt or ``stopping_generation``
(JAX's app.py:412-471).  The upscalers are the process's registry
(``postprocessing/upscalers``), which ``server/__main__`` fills from the
ESRGAN and Real-ESRGAN directories at start (JAX's app.py:44-57); so are
the LoRA, hypernetwork and ControlNet registries.  Every model the Engine
loads or is given gets a textual-inversion database of the embeddings
directory (app.py:143-154).  A request's LoRA set runs on a merged copy
that the base model caches and drops whenever it moves
(``networks/extra_networks``): the live, parked and cached models are
always the checkpoints' own weights.

Selectable scripts (``scripts/builtin``) run through ``run_script``: one
job for the whole script, each cell through ``txt2img_inner`` /
``img2img_inner`` on the cell's checkpoint (JAX's app.py:381-409).

Unlike JAX (``app.py:208-226``), a checkpoint load that fails leaves the
resident models as they were: the live model is moved back, and no parked
duplicate of it stays in the cache.
"""

from __future__ import annotations

import logging
import os
import threading

import torch

from sdwebui_tpu_torch.loader import load
from sdwebui_tpu_torch.loader.registry import CheckpointRegistry, file_sha256
from sdwebui_tpu_torch.models import vae_approx
from sdwebui_tpu_torch.networks.textual_inversion import (DEFAULT_EMBEDDINGS_DIR,
                                                          attach_embeddings)
from sdwebui_tpu_torch.ops.attention import set_attention_impl
from sdwebui_tpu_torch.pipeline.img2img import process_img2img
from sdwebui_tpu_torch.pipeline.params import GenerationParams, Processed
from sdwebui_tpu_torch.pipeline.processing import (decode_first_stage, image_grid,
                                                   process_txt2img, to_u8, uses_refiner)
from sdwebui_tpu_torch.pipeline.sd_model import (SDModel, create_random_sd15,
                                                 create_random_sdxl,
                                                 create_tiny_sd,
                                                 create_tiny_sdxl, dequantize_unet_fp8,
                                                 has_fp8, quantize_unet_fp8)
from sdwebui_tpu_torch.postprocessing.stages import StageArgs, run_stages
from sdwebui_tpu_torch.runtime.state import State
from sdwebui_tpu_torch.scripts import builtin  # noqa: F401  (registers the scripts)
from sdwebui_tpu_torch.scripts.framework import get_script, validate_script_args
from sdwebui_tpu_torch.text.styles import StyleDatabase
from sdwebui_tpu_torch.utils.devices import get_device
from sdwebui_tpu_torch.utils.options import opts

log = logging.getLogger(__name__)

#: opts.cross_attention_optimization → attention impl; "xla" is the JAX
#: package's plain einsum path (sdwebui_tpu/ops/attention.py:33-37), here
#: the plain PyTorch one
ATTENTION_IMPLS = {"Automatic": None, "flash": "flash", "flash-packed": "flash-packed",
                   "plain": "plain", "xla": "plain"}

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
    styles_path: the prompt styles' CSV; allow_code: the "Custom code"
    script runs (``--allow-code``)."""

    def __init__(self, device="cuda", tiny: bool = False, seed: int = 0,
                 model: SDModel | None = None, family: str = "sd15",
                 extra_models: dict[str, SDModel] | None = None,
                 ckpt: str | None = None, ckpt_dirs=None, vae_path: str | None = None,
                 vae_dirs=(DEFAULT_VAE_DIR,), hash_cache: str | None = DEFAULT_HASH_CACHE,
                 embeddings_dir: str = DEFAULT_EMBEDDINGS_DIR,
                 styles_path: str = DEFAULT_STYLES, allow_code: bool = False):
        self.device = get_device(device)
        self.allow_code = allow_code
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

    def _maybe_switch_checkpoint(self, p: GenerationParams):
        """override_settings.sd_model_checkpoint of one request (app.py:238-248);
        the switch lasts past the request, as in JAX."""
        want = (p.override_settings or {}).get("sd_model_checkpoint")
        if want and (self.registry is not None or want != self._model.title):
            self.reload_checkpoint(self._find(want, "sd_model_checkpoint").name)

    def _maybe_switch(self, p: GenerationParams):
        """override_settings.sd_model_checkpoint / sd_vae of one request
        (app.py:238-280)."""
        self._maybe_switch_checkpoint(p)
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
        self._apply_fp8_storage(self.sd_model)

    def _apply_fp8_storage(self, model: SDModel):
        """opts.fp8_storage "Enable", "Enable for SDXL" or "Disable"
        (app.py:94-125): the live UNet's conv and linear weights stored as
        fp8, converted in place; "Disable" restores the cache_fp16_weight
        copies where kept, else upcasts the stored codes (lossy)."""
        mode = opts.get("fp8_storage", "Disable")
        want = mode == "Enable" or (mode == "Enable for SDXL" and model.is_sdxl)
        if want and model.is_sd3:
            raise NotImplementedError("fp8_storage with an SD3 model is not ported (the JAX "
                                      "package's MMDiT has no fp8 upcast)")
        if want == has_fp8(model):
            return
        if want:
            quantize_unet_fp8(model, keep_hp=bool(opts.get("cache_fp16_weight", False)))
        else:
            dequantize_unet_fp8(model)

    def _step_callback(self, i: int, n: int, latents) -> bool:
        """The sampler's per-step hook (app.py:440-460): progress, a stop on
        interrupt or skip (a skip is cleared, so it ends only the batch in
        flight), and every opts.show_progress_every_n_steps steps a live
        preview of the latents in opts.show_progress_type."""
        self.state.set_sampling_step(i + 1, n)
        skipped = self.state.take_skip()
        if self.state.interrupted or skipped:
            return False
        every = int(opts.get("show_progress_every_n_steps", 10))
        if opts.get("live_previews_enable", True) and every > 0 and (i + 1) % every == 0:
            try:
                self.state.set_current_image(self._preview(latents))
            except Exception:     # a preview never stops the job, as in JAX
                log.exception("live preview failed")
        return True

    def _preview(self, latents):
        """Sampler-space latents → one uint8 RGB image: TAESD, Approx NN or
        the cheap approximation (``vae_approx.approx_decode``; a missing
        file falls back to the cheap one), or "Full" through the VAE; a
        grid of the batch with opts.show_progress_grid."""
        model = self.sd_model
        method = opts.get("show_progress_type", "Approx NN")
        if method == "Full":
            images = decode_first_stage(model, latents)
        else:
            rgb = vae_approx.approx_decode(model.kind, method, latents)
            images = to_u8(torch.nan_to_num(rgb))
        if opts.get("show_progress_grid", True) and len(images) > 1:
            return image_grid(list(images), 1)
        return images[0]

    def _batch_callback(self, kind: str, n: int, images) -> bool:
        """Before batch n: stop on interrupt or stopping_generation, else
        advance job_no; after it: its last image is the preview
        (app.py:464-471)."""
        if kind == "batch":
            if self.state.interrupted or self.state.stopping_generation:
                return False
            self.state.set_job_no(n)
        elif kind == "batch_done" and images:
            self.state.set_current_image(images[-1])
        return True

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
            self.state.begin(job, p.n_iter, self.device)
            try:
                return fn()
            finally:
                self.state.end()

    def txt2img(self, p: GenerationParams) -> Processed:
        return self._run("txt2img", p, lambda: process_txt2img(
            self.sd_model, p, step_callback=self._step_callback,
            refiner_model=self._resolve_refiner(p), interrupted=self._interrupted,
            callback=self._batch_callback))

    def extras(self, images: list, args: StageArgs) -> list:
        """The Extras stage chain over RGB uint8 images, one job; the face
        stages run on the Engine's device."""
        with self.queue_lock:
            self.state.begin("extras", len(images), self.device)
            try:
                out = []
                for n, im in enumerate(images):
                    self.state.set_job_no(n)
                    out.append(run_stages(im, args, device=self.device))
                return out
            finally:
                self.state.end()

    def _interrupted(self) -> bool:
        return self.state.interrupted

    def img2img(self, p: GenerationParams) -> Processed:
        """app.py:363-379: img2img and inpainting on the live model (an SDXL
        base or its 9-channel inpainting variant too)."""
        return self._run("img2img", p, lambda: process_img2img(
            self.sd_model, p, step_callback=self._step_callback,
            interrupted=self._interrupted, callback=self._batch_callback))

    # ---- scripts (app.py:381-409) ---------------------------------------

    def txt2img_inner(self, p: GenerationParams) -> Processed:
        """One script cell's txt2img: the cell's checkpoint and refiner, no
        new job and no VAE switch or styles, as in JAX (app.py:382-387).
        The sampler's step callback runs, so /progress shows the cell's
        steps and an interrupt stops it after the step in flight."""
        self._maybe_switch_checkpoint(p)
        return process_txt2img(self.sd_model, p, step_callback=self._step_callback,
                               refiner_model=self._resolve_refiner(p),
                               interrupted=self._interrupted)

    def img2img_inner(self, p: GenerationParams) -> Processed:
        """One script cell's img2img (app.py:389-393), as txt2img_inner."""
        self._maybe_switch_checkpoint(p)
        return process_img2img(self.sd_model, p, step_callback=self._step_callback,
                               interrupted=self._interrupted)

    def run_script(self, script_name: str, p: GenerationParams, script_args: list) -> Processed:
        """A selectable script over the request (app.py:395-409): its
        arguments checked, then one job, "script:<name>", for every cell it
        runs, under the queue lock.  What JAX's script path drops raises
        naming it: the request's styles and its sd_vae override (JAX's
        run_script applies neither)."""
        script = get_script(script_name)
        if script is None or script.alwayson:
            raise ValueError(f"unknown script {script_name!r}")
        validate_script_args(script, list(script_args or []))
        if p.styles:
            raise NotImplementedError("styles with a script_name are not ported (the JAX "
                                      "package's script path applies no styles)")
        if "sd_vae" in (p.override_settings or {}):
            raise NotImplementedError("override_settings 'sd_vae' with a script_name is not "
                                      "ported (the JAX package's script cells never switch "
                                      "the VAE)")
        with self.queue_lock:
            with opts.override(p.override_settings):
                self._apply_runtime_opts()
            self.state.begin(f"script:{script_name}", device=self.device)
            try:
                return script.run(self, p, *(script_args or []))
            finally:
                self.state.end()
