"""The gallery's Save / Save-as-zip buttons — port of
``sdwebui_tpu/server/ui_actions.py``: the posted images written to
opts.outdir_save (``utils/saving.save_image``), a ``log.csv`` row (its
columns padded when new ones appear) and, when asked, a zip archive named
by opts.grid_zip_filename_pattern (``zipfile``).  The images are base64
images in any format ``utils/image_io`` reads, saved as they decode (grey,
RGB or RGBA)."""

from __future__ import annotations

import base64
import csv
import json
import os
from types import SimpleNamespace
from zipfile import ZipFile

from sdwebui_tpu_torch.utils import infotext as infotext_util
from sdwebui_tpu_torch.utils import saving
from sdwebui_tpu_torch.utils.filename import FilenameGenerator
from sdwebui_tpu_torch.utils.image_io import decode_image
from sdwebui_tpu_torch.utils.options import opts

_LOG_FIELDS = [
    "prompt", "seed", "width", "height", "sampler", "cfgs", "steps",
    "filename", "negative_prompt", "sd_model_name", "sd_model_hash",
]


def _update_logfile(path: str, fields: list[str]) -> None:
    """Pad existing log.csv rows when new columns appear (reference
    modules/ui_common.py:39 update_logfile)."""
    with open(path, "r", encoding="utf8", newline="") as f:
        rows = list(csv.reader(f))
    if not rows or rows[0] == fields:
        return
    rows[0] = fields
    pad = len(fields)
    rows = [row + [""] * (pad - len(row)) for row in rows]
    with open(path, "w", encoding="utf8", newline="") as f:
        csv.writer(f).writerows(rows)


def _decode(filedata: str):
    """A base64 image (optionally a data: URL) → uint8 pixels."""
    raw = filedata.split(",", 1)[-1] if filedata.startswith("data:") else filedata
    return decode_image(base64.b64decode(raw))[0]


def save_files(js_data: dict, images: list, do_make_zip: bool = False,
               index: int = -1) -> dict:
    """Save gallery images (base64 image strings) to opts.outdir_save
    (ui_actions.py:36-140).

    js_data is the Processed.js() dict the generation response carried
    (prompt/seeds/infotexts/index_of_first_image...).  Returns
    {"files": [paths...], "zip": path|None, "saved": first relative name}.
    """
    data = dict(js_data or {})
    p = SimpleNamespace(
        prompt=data.get("prompt", ""), seed=data.get("seed", 0),
        all_seeds=data.get("all_seeds") or [data.get("seed", 0)],
        all_prompts=data.get("all_prompts") or [data.get("prompt", "")],
        negative_prompt=data.get("negative_prompt", ""),
        steps=data.get("steps", 0), cfg_scale=data.get("cfg_scale", 0),
        sampler_name=data.get("sampler_name", ""),
        width=data.get("width", 0), height=data.get("height", 0),
        batch_size=data.get("batch_size", 1), n_iter=1,
        styles=data.get("styles") or [], batch_index=0, iteration=0,
        seed_resize_from_w=0, seed_resize_from_h=0,
        sd_model_name=data.get("sd_model_name", ""),
        sd_model_hash=data.get("sd_model_hash", ""))
    infotexts = data.get("infotexts") or [""] * len(images)
    index_of_first_image = int(data.get("index_of_first_image", 0))

    path = opts.get("outdir_save", "log/images") or "log/images"
    save_to_dirs = bool(opts.get("use_save_to_dirs_for_ui", False))
    extension = opts.get("samples_format", "png") or "png"
    start_index = 0

    if index > -1 and opts.get("save_selected_only", True) \
            and index >= index_of_first_image:
        images = [images[index]]
        infotexts = infotexts[index:index + 1] if index < len(infotexts) else [""]
        start_index = index

    os.makedirs(path, exist_ok=True)
    logfile_path = os.path.join(path, "log.csv")
    write_log = bool(opts.get("save_write_log_csv", True))
    if write_log and os.path.exists(logfile_path):
        _update_logfile(logfile_path, _LOG_FIELDS)

    filenames, fullfns, parsed = [], [], []
    image = None
    for image_index, filedata in enumerate(images, start_index):
        image = _decode(filedata)
        is_grid = image_index < index_of_first_image
        p.batch_index = image_index - 1
        info = infotexts[image_index - start_index] \
            if image_index - start_index < len(infotexts) else ""
        params = infotext_util.parse(info) if info else {}
        parsed.append(params)
        fullfn = saving.save_image(
            image, path, basename="",
            seed=params.get("Seed", p.seed), prompt=params.get("Prompt", p.prompt),
            extension=extension, info=info, grid=is_grid, p=p,
            save_to_dirs=save_to_dirs)
        filenames.append(os.path.relpath(fullfn, path))
        fullfns.append(fullfn)

    saving.flush_saves()

    if write_log:
        first = parsed[0] if parsed else {}
        at_start = not os.path.exists(logfile_path) or os.path.getsize(logfile_path) == 0
        with open(logfile_path, "a", encoding="utf8", newline="") as f:
            writer = csv.writer(f)
            if at_start:
                writer.writerow(_LOG_FIELDS)
            writer.writerow([
                first.get("Prompt", p.prompt), first.get("Seed", p.seed),
                data.get("width", ""), data.get("height", ""),
                data.get("sampler_name", ""), data.get("cfg_scale", ""),
                data.get("steps", ""), filenames[0] if filenames else "",
                first.get("Negative prompt", p.negative_prompt),
                data.get("sd_model_name", ""), data.get("sd_model_hash", "")])

    zip_filepath = None
    if do_make_zip and fullfns:
        p.all_seeds = [pa.get("Seed", p.seed) for pa in parsed] or p.all_seeds
        namegen = FilenameGenerator(
            p, parsed[0].get("Seed", p.seed) if parsed else p.seed,
            parsed[0].get("Prompt", p.prompt) if parsed else p.prompt,
            saving.PixelView(image), zip=True)
        zip_name = namegen.apply(opts.get("grid_zip_filename_pattern", "")
                                 or "[datetime]_[[model_name]]_[seed]-[seed_last]")
        zip_filepath = os.path.join(path, f"{zip_name}.zip")
        with ZipFile(zip_filepath, "w") as zf:
            for name, full in zip(filenames, fullfns):
                with open(full, "rb") as f:
                    zf.writestr(name, f.read())

    return {"files": fullfns, "zip": zip_filepath,
            "saved": filenames[0] if filenames else ""}


def save_files_from_json(body: dict) -> dict:
    """HTTP adapter: body = {js_data|info: dict|str, images: [b64...],
    do_make_zip: bool, index: int}."""
    js_data = body.get("js_data") or body.get("info") or {}
    if isinstance(js_data, str):
        try:
            js_data = json.loads(js_data)
        except ValueError:
            js_data = {}
    return save_files(js_data, body.get("images") or [],
                      bool(body.get("do_make_zip", False)),
                      int(body.get("index", -1)))
