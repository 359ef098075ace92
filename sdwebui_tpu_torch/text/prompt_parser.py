"""Prompt syntax: attention weights, edit schedules, alternation, AND.

Behaviour-compatible with the reference's lark-based parser
(modules/prompt_parser.py — `[from:to:when]`, `[x|y]`, `(emph:1.2)`,
`AND`-composition, `BREAK`), implemented as a hand-rolled recursive-descent
parser (no grammar dependency).  Golden cases in tests/test_prompt_parser.py
were produced by running the reference parser.

Copy of ``sdwebui_tpu/text/prompt_parser.py``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List


# ==========================================================================
# schedules: [from:to:when], [to:when], [from::when], [a|b|c]
# ==========================================================================
# Faithful to the reference's lark grammar (modules/prompt_parser.py:15-26)
# as a hand-rolled recursive-descent parser, including its failure
# semantics, which carry user-visible behavior:
#   - a bracket that is not a valid schedule/alternation/emphasis is NOT a
#     construct: its '[' becomes a stray literal char and the *content* is
#     re-parsed at top level (nested schedules inside stay active);
#   - a bare '|' outside a valid alternation, or a dangling '\', fails the
#     whole prompt -> [[steps, prompt]] verbatim (lark.LarkError path);
#   - plain text consumes escapes ('\]' does not close a bracket) and keeps
#     them raw (unescaping happens later, in the attention parser);
#   - the schedule number is lark SIGNED_NUMBER (exponents allowed), and
#     the int-vs-float distinction is made on the *literal* ('.' present),
#     not the value — "[x:2.0]" switches at 2.0*steps, "[x:2]" at step 2.

class _ParseFail(Exception):
    pass


def strip_comments(text: str) -> str:
    """# line comments (reference processing_scripts/comments.py
    strip_comments, gated on opts.enable_prompt_comments)."""
    text = re.sub(r"(^|\n)#[^\n]*(\n|$)", "\n", text)
    text = re.sub(r"#[^\n]*(\n|$)", "\n", text)
    return text


@dataclasses.dataclass
class _Text:
    s: str


@dataclasses.dataclass
class _Seq:
    items: list


@dataclasses.dataclass
class _Sched:
    before: "_Seq | None"
    after: "_Seq"
    when_raw: str                 # NUMBER literal as written (ws stripped)
    when: int = 0                 # resolved bound, filled by _collect_steps


@dataclasses.dataclass
class _Alt:
    options: list


@dataclasses.dataclass
class _Emph:
    """!emphasized — tokens are kept, so it renders with its delimiters."""
    parts: list                   # [p] for (p)/[p], [p1, p2] for (p1:p2)
    square: bool = False


_PLAIN_RE = re.compile(r"(?:[^\\\[\]():|]|\\.)+")
# lark common.SIGNED_NUMBER: [+-] (INT | INT.INT? | .INT | FLOAT exp forms)
_NUM_RE = re.compile(r"[+-]?(?:(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)")


def _p_prompt(s: str, pos: int):
    """Grammar `prompt`: zero or more of emphasized/scheduled/alternate/
    plain/whitespace.  Stops (without failing) at anything else."""
    items = []
    while pos < len(s):
        ch = s[pos]
        if ch == "(":
            try:
                node, pos = _p_paren(s, pos + 1)
            except _ParseFail:
                break
            items.append(node)
        elif ch == "[":
            try:
                node, pos = _p_bracket(s, pos + 1)
            except _ParseFail:
                break
            items.append(node)
        else:
            m = _PLAIN_RE.match(s, pos)
            if m is None:
                break
            items.append(_Text(m.group(0)))
            pos = m.end()
    return _Seq(items), pos


def _p_paren(s: str, pos: int):
    """'(' prompt ')' | '(' prompt ':' prompt ')' — after the '('."""
    p1, pos = _p_prompt(s, pos)
    if pos < len(s) and s[pos] == ")":
        return _Emph([p1]), pos + 1
    if pos < len(s) and s[pos] == ":":
        p2, pos = _p_prompt(s, pos + 1)
        if pos < len(s) and s[pos] == ")":
            return _Emph([p1, p2]), pos + 1
    raise _ParseFail


def _p_bracket(s: str, pos: int):
    """scheduled | alternate | '[' prompt ']' — after the '['."""
    parts = []
    seps = []
    spans = []
    while True:
        start = pos
        seq, pos = _p_prompt(s, pos)
        parts.append(seq)
        spans.append(s[start:pos])
        if pos >= len(s) or s[pos] not in ":|]":
            raise _ParseFail
        ch = s[pos]
        pos += 1
        if ch == "]":
            break
        seps.append(ch)

    if not seps:
        return _Emph(parts, square=True), pos

    if all(c == "|" for c in seps):
        return _Alt(parts), pos

    def number_part(i):
        """The when-part must be [WS] NUMBER [WS] — literally, not via
        nested constructs."""
        raw = spans[i].strip()
        ok = (len(parts[i].items) == 1 and isinstance(parts[i].items[0], _Text)
              and _NUM_RE.fullmatch(raw))
        return raw if ok else None

    if len(seps) == 1 and seps[0] == ":":
        raw = number_part(1)
        if raw is None:
            raise _ParseFail
        return _Sched(None, parts[0], raw), pos
    if len(seps) == 2 and seps == [":", ":"]:
        raw = number_part(2)
        if raw is None:
            raise _ParseFail
        return _Sched(parts[0], parts[1], raw), pos
    raise _ParseFail


def _p_start(s: str):
    """Grammar `start`: (prompt | stray "][():"+)*.  A '|' or dangling '\\'
    that no rule covers fails the whole prompt (lark.LarkError path)."""
    items = []
    pos = 0
    while pos < len(s):
        seq, pos = _p_prompt(s, pos)
        items.extend(seq.items)
        if pos >= len(s):
            break
        if s[pos] in "[]():":
            items.append(_Text(s[pos]))
            pos += 1
        else:                     # '|' or dangling '\'
            raise _ParseFail
    return _Seq(items)


def _collect_steps(node, steps: int, out: set,
                   int_offset: int, flt_offset: float,
                   use_old_scheduling: bool):
    """Visit schedules, resolving each NUMBER literal to an integer bound
    (mutating node.when, as the reference's CollectSteps visitor does)."""
    if isinstance(node, _Seq):
        for i in node.items:
            _collect_steps(i, steps, out, int_offset, flt_offset,
                           use_old_scheduling)
    elif isinstance(node, _Emph):
        for p in node.parts:
            _collect_steps(p, steps, out, int_offset, flt_offset,
                           use_old_scheduling)
    elif isinstance(node, _Sched):
        v = float(node.when_raw)
        if use_old_scheduling:
            v = v * steps if v < 1 else v
        elif "." in node.when_raw:
            v = (v - flt_offset) * steps
        else:
            v = v - int_offset
        node.when = min(steps, int(v))
        if node.when >= 1:
            out.add(node.when)
        if node.before is not None:
            _collect_steps(node.before, steps, out, int_offset, flt_offset,
                           use_old_scheduling)
        _collect_steps(node.after, steps, out, int_offset, flt_offset,
                       use_old_scheduling)
    elif isinstance(node, _Alt):
        out.update(range(1, steps + 1))
        for o in node.options:
            _collect_steps(o, steps, out, int_offset, flt_offset,
                           use_old_scheduling)


def _render_at(node, step: int) -> str:
    if isinstance(node, _Text):
        return node.s
    if isinstance(node, _Seq):
        return "".join(_render_at(i, step) for i in node.items)
    if isinstance(node, _Emph):
        inner = (":".join(_render_at(p, step) for p in node.parts))
        return ("[" + inner + "]") if node.square else ("(" + inner + ")")
    if isinstance(node, _Sched):
        if step <= node.when:
            return _render_at(node.before, step) if node.before is not None else ""
        return _render_at(node.after, step)
    if isinstance(node, _Alt):
        opt = node.options[(step - 1) % len(node.options)]
        return _render_at(opt, step)
    raise TypeError(node)


def get_prompt_schedule(prompt: str, steps: int, hires_steps: int | None = None,
                        use_old_scheduling: bool = False) -> List[list]:
    """[[end_step, prompt_text], ...] — reference
    get_learned_conditioning_prompt_schedules semantics for one prompt.

    With ``hires_steps`` (and new-style scheduling), schedule numbers
    continue past the first pass: integers are offset by ``steps``, floats
    by 1.0 — reference modules/prompt_parser.py:69-74."""
    if hires_steps is None or use_old_scheduling:
        int_offset, flt_offset, eff_steps = 0, 0.0, steps
    else:
        int_offset, flt_offset, eff_steps = steps, 1.0, hires_steps
    try:
        tree = _p_start(prompt)
    except _ParseFail:
        return [[eff_steps, prompt]]
    bounds: set = {eff_steps}
    _collect_steps(tree, eff_steps, bounds, int_offset, flt_offset,
                   use_old_scheduling)
    return [[b, _render_at(tree, b)] for b in sorted(bounds)]


def get_prompt_schedules(prompts, steps: int, hires_steps: int | None = None,
                         use_old_scheduling: bool = False):
    cache = {}
    out = []
    for p in prompts:
        if p not in cache:
            cache[p] = get_prompt_schedule(p, steps, hires_steps,
                                           use_old_scheduling)
        out.append(cache[p])
    return out


# ==========================================================================
# attention: (x) (x:1.5) [x] \( BREAK
# ==========================================================================

_ATTN_RE = re.compile(r"""
\\\(|\\\)|\\\[|\\]|\\\\|\\|
\(|\[|:\s*([+-]?[.\d]+)\s*\)|
\)|]|[^\\()\[\]:]+|:
""", re.X)

_BREAK_RE = re.compile(r"\s*\bBREAK\b\s*")


def parse_prompt_attention(text: str) -> List[list]:
    """[[text, weight]] — reference modules/prompt_parser.py:370 semantics."""
    res: List[list] = []
    round_brackets: List[int] = []
    square_brackets: List[int] = []

    round_bracket_multiplier = 1.1
    square_bracket_multiplier = 1 / 1.1

    def multiply_range(start, multiplier):
        for p in range(start, len(res)):
            res[p][1] *= multiplier

    for m in _ATTN_RE.finditer(text):
        tok = m.group(0)
        weight = m.group(1)

        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_brackets.append(len(res))
        elif tok == "[":
            square_brackets.append(len(res))
        elif weight is not None and round_brackets:
            multiply_range(round_brackets.pop(), float(weight))
        elif tok == ")" and round_brackets:
            multiply_range(round_brackets.pop(), round_bracket_multiplier)
        elif tok == "]" and square_brackets:
            multiply_range(square_brackets.pop(), square_bracket_multiplier)
        else:
            parts = _BREAK_RE.split(tok)
            for i, part in enumerate(parts):
                if i > 0:
                    res.append(["BREAK", -1])
                # empty parts are appended too (reference behaviour): they
                # keep a bracketed BREAK's weight ≠ -1, which downstream
                # treats as literal text, not a chunk break
                res.append([part, 1.0])

    for pos in round_brackets:
        multiply_range(pos, round_bracket_multiplier)
    for pos in square_brackets:
        multiply_range(pos, square_bracket_multiplier)

    if not res:
        res = [["", 1.0]]

    # merge runs with identical weight
    i = 0
    while i + 1 < len(res):
        if res[i][1] == res[i + 1][1]:
            res[i][0] += res[i + 1][0]
            del res[i + 1]
        else:
            i += 1
    return res


# ==========================================================================
# AND composition
# ==========================================================================

_AND_RE = re.compile(r"\bAND\b")
_WEIGHT_RE = re.compile(r"^(.*?)(?:\s*:\s*([-+]?(?:\d+\.?\d*|\.\d+)))?\s*$", re.DOTALL)


@dataclasses.dataclass
class SubPrompt:
    text: str
    weight: float


def split_multicond(prompt: str) -> List[SubPrompt]:
    """'a AND b :0.4' → [SubPrompt('a',1.0), SubPrompt(' b',0.4)]."""
    out = []
    for part in _AND_RE.split(prompt):
        m = _WEIGHT_RE.fullmatch(part)
        text = m.group(1)
        weight = float(m.group(2)) if m.group(2) else 1.0
        out.append(SubPrompt(text, weight))
    return out
