"""Infotext codec: generation parameters ↔ "parameters" text.

Format-compatible with the reference (modules/processing.py:705
create_infotext; modules/infotext_utils.py:234 parse_generation_parameters)
so images carry their own reproduction recipe and round-trip through
PNG-info / paste / API.

Copy of ``sdwebui_tpu/utils/infotext.py``."""

from __future__ import annotations

import re


def quote(text):
    text = str(text)
    if "," not in text and "\n" not in text and ":" not in text:
        return text
    return '"' + text.replace("\\", "\\\\").replace('"', '\\"') + '"'


def unquote(text: str):
    if len(text) == 0 or text[0] != '"' or text[-1] != '"':
        return text
    try:
        import json

        return json.loads(text)
    except Exception:
        return text


def build(prompt: str, negative_prompt: str, params: dict) -> str:
    pairs = ", ".join(f"{k}: {quote(v)}" for k, v in params.items() if v is not None)
    neg = f"\nNegative prompt: {negative_prompt}" if negative_prompt else ""
    return f"{prompt}{neg}\n{pairs}".strip()


_PARAM_RE = re.compile(r"""
\s*([\w ]+):\s*
("(?:\\.|[^\\"])+"|[^,]*)
(?:,|$)
""", re.X)

_SIZE_RE = re.compile(r"^(\d+)x(\d+)$")


def parse(text: str) -> dict:
    """parameters text → flat dict (reference parse_generation_parameters)."""
    res: dict = {}
    if not text:
        return res
    *prompt_lines, lastline = text.strip().split("\n")
    if len(_PARAM_RE.findall(lastline)) < 3:
        prompt_lines.append(lastline)
        lastline = ""

    prompt, negative = [], []
    in_negative = False
    for line in prompt_lines:
        line = line.strip()
        if line.startswith("Negative prompt:"):
            in_negative = True
            line = line[len("Negative prompt:"):].strip()
        (negative if in_negative else prompt).append(line)
    res["Prompt"] = "\n".join(prompt)
    res["Negative prompt"] = "\n".join(negative)

    for k, v in _PARAM_RE.findall(lastline):
        k = k.strip()
        v = unquote(v.strip())
        m = _SIZE_RE.match(str(v))
        if m and k == "Size":
            res["Size-1"] = int(m.group(1))
            res["Size-2"] = int(m.group(2))
        res[k] = v
    return res


# --------------------------------------------------------------------------
# version backcompat (reference modules/infotext_versions.py)
# --------------------------------------------------------------------------

def parse_version(text):
    """'1.6.0' / 'v1.7.0-225-gabcdef' → comparable tuple, or None."""
    import re

    if not text:
        return None
    m = re.match(r"v?(\d+)\.(\d+)\.(\d+)(?:-(\d+))?", text)
    if not m:
        return None
    return tuple(int(g or 0) for g in m.groups())


def backcompat(d: dict):
    """Inspect the pasted infotext's Version field and record the
    compatibility toggles old images relied on (reference backcompat,
    modules/infotext_versions.py:26). Toggles for behaviors this engine
    reproduces natively are recorded for transparency; "Downcast
    alphas_cumprod" has no effect (alphas are always fp32 here)."""
    from sdwebui_tpu_torch.utils.options import opts

    if not opts.get("auto_backcompat", True):
        return d
    ver = parse_version(d.get("Version"))
    if ver is None or d.get("Version", "").startswith("sdwebui-tpu"):
        return d
    if ver < (1, 6, 0) and "[" in d.get("Prompt", ""):
        d["Old prompt editing timelines"] = True
    if ver < (1, 6, 0) and d.get("Sampler", "") in ("DDIM", "PLMS"):
        d["Pad conds v0"] = True
    if ver < (1, 7, 0, 225):
        d["Downcast alphas_cumprod"] = True
    if ver < (1, 8, 0) and d.get("Refiner"):
        d["Refiner switch by sampling steps"] = True
    return d
