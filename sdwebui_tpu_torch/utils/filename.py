"""Filename-pattern engine for saved images — a copy of
``sdwebui_tpu/utils/filename.py`` (no JAX in it; the port keeps its own
copy, held equal by tests/test_torch_copies.py).

The ``[token]`` names, ``<arg>`` suffix grammar, and skip-previous-text
semantics are a compatibility contract with the reference's
samples_filename_pattern option: users carry these patterns between
installs, so every token must resolve to the same text.  Tokens are
ordinary methods registered with the @_token decorator, and pattern
expansion is a single tokenizer loop over ``literal [name<arg>…]``
segments.  The image is anything with ``width``, ``height`` and
``tobytes()`` (``utils/saving`` passes a view of the uint8 pixels, whose
bytes are what Pillow's ``tobytes()`` gives for the same image).
``[vae_filename]`` reads the request's ``sd_vae_file`` (the pipelines set
it from the live model's VAE file) where the JAX package reads its
loader's global.

Drives the samples_filename_pattern / directories_filename_pattern options.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import re
import string

from sdwebui_tpu_torch.utils.saving import sanitize_filename_part


class _SkipToken:
    """Sentinel: token resolves to nothing AND eats the literal text before
    it (so "foo-[seed_last]" at batch_size=1 drops the "foo-" too)."""


SKIP = _SkipToken()

_WORD_SPLIT = re.compile(r"[\s" + string.punctuation + "]+")
_SEGMENT = re.compile(r"(.*?)(?:\[([^\[\]]+)\]|$)")
_TRAILING_ARG = re.compile(r"(.*)<([^>]*)>$")

_TOKENS: dict = {}


def _token(name):
    """Register a FilenameGenerator method as the handler for [name]."""
    def register(fn):
        _TOKENS[name] = fn
        return fn
    return register


def _opt(key, default=None):
    from sdwebui_tpu_torch.utils.options import opts

    return opts.get(key, default)


def _clean(text, keep_spaces=True):
    return sanitize_filename_part(text, replace_spaces=not keep_spaces)


class FilenameGenerator:
    default_time_format = "%Y%m%d%H%M%S"

    def __init__(self, p, seed, prompt, image, zip=False, basename=""):
        self.p = p
        self.seed = seed
        self.prompt = prompt
        self.image = image
        self.zip = zip
        self.basename = basename

    # ---- expansion -----------------------------------------------------

    def apply(self, pattern: str) -> str:
        """Expand every ``literal[token<arg>…]`` segment of the pattern.
        Unknown tokens are kept verbatim (including brackets); a handler
        error keeps the segment verbatim too; SKIP drops the token and its
        preceding literal."""
        out = []
        for match in _SEGMENT.finditer(pattern):
            literal, token_expr = match.groups()
            if token_expr is None:
                out.append(literal)
                continue
            name, args = self._split_args(token_expr)
            handler = _TOKENS.get(name.lower())
            value = None
            if handler is not None:
                try:
                    value = handler(self, *args)
                except Exception:
                    value = None
            if value is SKIP:
                continue
            if value is None:
                out.append(f"{literal}[{token_expr}]")
            else:
                out.append(literal + str(value))
        return "".join(out)

    @staticmethod
    def _split_args(token_expr: str):
        """Peel trailing <arg> suffixes: "datetime<%Y><UTC>" ->
        ("datetime", ["%Y", "UTC"])."""
        args = []
        while (m := _TRAILING_ARG.match(token_expr)) is not None:
            token_expr, arg = m.groups()
            args.insert(0, arg)
        return token_expr, args

    # ---- simple field tokens -------------------------------------------

    @_token("basename")
    def _basename(self):
        return self.basename or "img"

    @_token("none")
    def _none(self):
        return ""

    @_token("seed")
    def _seed(self):
        return self.seed if self.seed is not None else ""

    @_token("seed_first")
    def _seed_first(self):
        return self.seed if self.p.batch_size == 1 else self.p.all_seeds[0]

    @_token("seed_last")
    def _seed_last(self):
        return SKIP if self.p.batch_size == 1 else self.p.all_seeds[-1]

    @_token("steps")
    def _steps(self):
        return self.p and self.p.steps

    @_token("cfg")
    def _cfg(self):
        return self.p and self.p.cfg_scale

    @_token("width")
    def _width(self):
        return self.image.width

    @_token("height")
    def _height(self):
        return self.image.height

    @_token("batch_size")
    def _batch_size(self):
        return self.p.batch_size

    @_token("clip_skip")
    def _clip_skip(self):
        return _opt("CLIP_stop_at_last_layers")

    @_token("denoising")
    def _denoising(self):
        if self.p and self.p.denoising_strength:
            return self.p.denoising_strength
        return SKIP

    @_token("user")
    def _user(self):
        return getattr(self.p, "user", None) or SKIP

    @_token("model_hash")
    def _model_hash(self):
        return getattr(self.p, "sd_model_hash", "") or SKIP

    @_token("model_name")
    def _model_name(self):
        name = _clean(getattr(self.p, "sd_model_name", "") or "")
        return name or SKIP

    @_token("styles")
    def _styles(self):
        if not self.p:
            return None
        joined = ", ".join(s for s in self.p.styles if s != "None")
        return _clean(joined or "None")

    # ---- batch-position tokens -------------------------------------------

    @_token("batch_number")
    def _batch_number(self):
        if self.p.batch_size == 1 or self.zip:
            return SKIP
        return getattr(self.p, "batch_index", 0) + 1

    @_token("generation_number")
    def _generation_number(self):
        if (self.p.n_iter == 1 and self.p.batch_size == 1) or self.zip:
            return SKIP
        iteration = getattr(self.p, "iteration", 0)
        return iteration * self.p.batch_size + getattr(self.p, "batch_index", 0) + 1

    # ---- sampler / scheduler tokens ---------------------------------------

    @_token("sampler")
    def _sampler(self):
        return self.p and _clean(self.p.sampler_name)

    @_token("sampler_scheduler")
    def _sampler_scheduler(self):
        return self.p and self._scheduler_text(with_sampler=True)

    @_token("scheduler")
    def _scheduler(self):
        return self.p and self._scheduler_text(with_sampler=False)

    def _scheduler_text(self, with_sampler: bool):
        scheduler = getattr(self.p, "scheduler", None)
        sampler_name = getattr(self.p, "sampler_name", None)
        if scheduler is None or sampler_name is None:
            return SKIP
        if scheduler == "Automatic":
            from sdwebui_tpu_torch.sampling.registry import get_sampler

            try:
                scheduler = (get_sampler(sampler_name).scheduler_override
                             or "Automatic")
            except ValueError:
                pass
        name = scheduler.capitalize()
        return _clean(f"{sampler_name} {name}" if with_sampler else name)

    # ---- prompt tokens -----------------------------------------------------

    @_token("prompt")
    def _prompt(self):
        return sanitize_filename_part(self.prompt)

    @_token("prompt_spaces")
    def _prompt_spaces(self):
        return _clean(self.prompt)

    @_token("prompt_words")
    def _prompt_words(self):
        words = [w for w in _WORD_SPLIT.split(self.prompt or "") if w]
        limit = _opt("directories_max_prompt_words", 8)
        return _clean(" ".join(words[:limit] or ["empty"]))

    @_token("prompt_no_styles")
    def _prompt_no_styles(self):
        if self.p is None or self.prompt is None:
            return None
        from sdwebui_tpu_torch.text.styles import get_style_database

        remaining = self.prompt
        for style in get_style_database().get_style_prompts(self.p.styles):
            if not style:
                continue
            for fragment in style.split("{prompt}"):
                remaining = (remaining.replace(fragment, "")
                             .replace(", ,", ",").strip().strip(","))
            remaining = remaining.replace(style, "").strip().strip(",").strip()
        return _clean(remaining)

    @_token("hasprompt")
    def _hasprompt(self, *specs):
        """[hasprompt<term|fallback>…]: emit term if present in the prompt,
        else the fallback (if given)."""
        if self.p is None or self.prompt is None:
            return None
        lowered = self.prompt.lower()
        parts = []
        for spec in specs:
            if spec == "":
                continue
            term, _, fallback = spec.partition("|")
            if lowered.find(term.lower()) >= 0:
                parts.append(term.lower())
            elif fallback:
                parts.append(fallback)
        return sanitize_filename_part("".join(parts))

    # ---- hash tokens -------------------------------------------------------

    @staticmethod
    def _sha(data: bytes, length) -> str:
        return hashlib.sha256(data).hexdigest()[:length]

    @_token("prompt_hash")
    def _prompt_hash(self, *args):
        return self._text_hash(self.prompt, *args)

    @_token("negative_prompt_hash")
    def _negative_prompt_hash(self, *args):
        return self._text_hash(self.p.negative_prompt, *args)

    @_token("full_prompt_hash")
    def _full_prompt_hash(self, *args):
        return self._text_hash(
            f"{self.p.prompt} {self.p.negative_prompt}", *args)

    def _text_hash(self, text, *args):
        length = int(args[0]) if args and args[0] != "" else 8
        return self._sha((text or "").encode(), length)

    @_token("image_hash")
    def _image_hash(self, *args):
        length = int(args[0]) if args and args[0] != "" else None
        return self._sha(self.image.tobytes(), length)

    # ---- time tokens ---------------------------------------------------------

    @_token("date")
    def _date(self):
        return datetime.datetime.now().strftime("%Y-%m-%d")

    @_token("job_timestamp")
    def _job_timestamp(self):
        stamp = getattr(self.p, "job_timestamp", "")
        return stamp or datetime.datetime.now().strftime(self.default_time_format)

    @_token("datetime")
    def _datetime(self, *args):
        """[datetime<format><timezone>]: zoneinfo replaces the reference's
        pytz dependency."""
        fmt = args[0] if args and args[0] != "" else self.default_time_format
        tz = None
        if len(args) > 1:
            try:
                import zoneinfo

                tz = zoneinfo.ZoneInfo(args[1])
            except Exception:
                tz = None
        stamped = datetime.datetime.now().astimezone(tz)
        try:
            text = stamped.strftime(fmt)
        except (ValueError, TypeError):
            text = stamped.strftime(self.default_time_format)
        return _clean(text)

    # ---- model-asset tokens ---------------------------------------------------

    @_token("vae_filename")
    def _vae_filename(self):
        loaded = getattr(self.p, "sd_vae_file", None)
        if not loaded:
            return "NoneType"
        pieces = os.path.basename(loaded).split(".")
        if len(pieces) > 1 and pieces[0] == "":
            return pieces[1]  # dotfiles: ".vae.pt" -> "vae"
        return pieces[0]

    # kept as a class attribute so callers/tests can introspect the registry
    replacements = _TOKENS


def get_next_sequence_number(path: str, basename: str) -> int:
    """Next auto-number: scan `path` for "<basename->NNN-…" files and return
    max(NNN)+1 (reference images.py:633 contract; 0 for an empty dir)."""
    prefix = f"{basename}-" if basename else ""
    highest = -1
    for entry in os.listdir(path):
        if not entry.startswith(prefix):
            continue
        stem = os.path.splitext(entry[len(prefix):])[0]
        first = stem.split("-", 1)[0]
        try:
            highest = max(highest, int(first))
        except ValueError:
            pass
    return highest + 1
