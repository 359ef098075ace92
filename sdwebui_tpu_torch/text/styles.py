"""CSV-backed prompt styles (reference modules/styles.py): `{prompt}`
placeholder substitution, apply to positive+negative, extraction back out.

A copy of ``sdwebui_tpu/text/styles.py`` (no JAX in it; the port keeps its
own copy, held equal by tests/test_torch_copies.py)."""

from __future__ import annotations

import csv
import dataclasses
import os


@dataclasses.dataclass
class PromptStyle:
    name: str
    prompt: str = ""
    negative_prompt: str = ""


def merge_prompts(style_prompt: str, prompt: str) -> str:
    if "{prompt}" in style_prompt:
        return style_prompt.replace("{prompt}", prompt)
    parts = filter(None, (prompt.strip(), style_prompt.strip()))
    return ", ".join(parts)


def apply_styles_to_prompt(prompt: str, styles: list) -> str:
    for style in styles:
        prompt = merge_prompts(style, prompt)
    return prompt


def extract_original_prompt(style_prompt: str, prompt: str):
    """Reverse-apply one style; returns (stripped_prompt, matched)."""
    if not style_prompt:
        return prompt, True
    if "{prompt}" in style_prompt:
        left, _, right = style_prompt.partition("{prompt}")
        if prompt.startswith(left) and prompt.endswith(right):
            return prompt[len(left): len(prompt) - len(right)], True
        return prompt, False
    if prompt.endswith(style_prompt):
        stripped = prompt[: len(prompt) - len(style_prompt)]
        if stripped.endswith(", "):
            stripped = stripped[:-2]
        return stripped, True
    return prompt, False


class StyleDatabase:
    def __init__(self, path: str = "styles.csv"):
        self.path = path
        self.styles: dict[str, PromptStyle] = {}
        self.load()

    def load(self):
        self.styles = {}
        if not os.path.exists(self.path):
            return
        with open(self.path, encoding="utf-8-sig", newline="") as f:
            for row in csv.DictReader(f):
                name = row.get("name")
                if not name:
                    continue
                self.styles[name] = PromptStyle(
                    name, row.get("prompt") or "",
                    row.get("negative_prompt") or "")

    def load_extra(self, path: str):
        """Merge styles from an additional csv (extension-provided) without
        touching the primary file."""
        if not os.path.exists(path):
            return
        with open(path, encoding="utf-8-sig", newline="") as f:
            for row in csv.DictReader(f):
                name = row.get("name")
                if not name or name in self.styles:
                    continue
                self.styles[name] = PromptStyle(
                    name, row.get("prompt") or "",
                    row.get("negative_prompt") or "")

    def save(self):
        with open(self.path, "w", encoding="utf-8-sig", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["name", "prompt", "negative_prompt"])
            w.writeheader()
            for s in self.styles.values():
                w.writerow({"name": s.name, "prompt": s.prompt,
                            "negative_prompt": s.negative_prompt})

    def apply(self, prompt: str, negative_prompt: str, style_names: list):
        pos = [self.styles[n].prompt for n in style_names if n in self.styles]
        neg = [self.styles[n].negative_prompt for n in style_names if n in self.styles]
        return (apply_styles_to_prompt(prompt, pos),
                apply_styles_to_prompt(negative_prompt, neg))

    def get_style_prompts(self, style_names: list):
        return [self.styles[n].prompt for n in (style_names or [])
                if n in self.styles]

    def extract_styles_from_prompt(self, prompt: str, negative_prompt: str):
        """Greedy reverse-apply of known styles (reference
        modules/styles.py extract_styles_from_prompt): returns
        (style_names, stripped_prompt, stripped_negative)."""
        extracted = []
        remaining = list(self.styles.values())
        while True:
            found = None
            for style in remaining:
                p2, ok_p = extract_original_prompt(style.prompt, prompt)
                n2, ok_n = extract_original_prompt(style.negative_prompt,
                                                   negative_prompt)
                if ok_p and ok_n and (style.prompt or style.negative_prompt):
                    found = style
                    prompt, negative_prompt = p2, n2
                    remaining.remove(style)
                    break
            if found is None:
                break
            extracted.append(found.name)
        return list(reversed(extracted)), prompt, negative_prompt


_default_db: "StyleDatabase | None" = None


def get_style_database() -> "StyleDatabase":
    """Process-wide style registry (the Engine shares this instance)."""
    global _default_db
    if _default_db is None:
        _default_db = StyleDatabase()
    return _default_db
