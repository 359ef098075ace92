"""Saving images with their infotext — port of the saving half of
``sdwebui_tpu/utils/images.py:34-330``.

``save_image`` takes every step JAX's takes: the file name from
``utils/filename.FilenameGenerator`` (``samples_filename_pattern``,
``save_to_dirs`` with ``directories_filename_pattern``, numbering,
``save_images_replace_action``), the ``before_image_saved`` /
``image_saved`` callbacks of ``scripts/framework``, the ``f_namemax``
cut, the name reserved synchronously, then the write, as JAX's
``save_image_with_geninfo`` makes it: PNG at ``sdtpu_png_compress_level``
with its ``parameters`` text (``utils/png``); JPEG (``.jpg`` / ``.jpeg``)
and WebP at ``jpeg_quality`` with the infotext as an EXIF UserComment
(``utils/jpeg``, ``utils/webp``, ``utils/exif``), WebP lossless under
``webp_lossless`` and from RGB (JAX converts RGBA first); GIF with the
infotext as its comment (``utils/gif``); every other extension Pillow
registers a writer for goes through JAX's generic branch
(``image.save(f, format, quality=...)``, no infotext), and is written as
Pillow writes it: BMP, DIB, TIFF, JPEG's other names (``.jfif``, ``.jpe``)
and MPO (a plain JPEG), APNG (a PNG), Netpbm (``utils/netpbm``: P6 or P5
whatever the extension), TGA (``.tga``, ``.icb``, ``.vda``, ``.vst``), QOI,
SGI (``.sgi``, ``.rgb``, ``.rgba``, ``.bw``), PCX, DDS, IM, ICO, ICNS, PDF
and EPS / PS (``utils/pdf``), JPEG 2000 (``utils/jpeg2000``: ``.jp2``,
``.jpx``, ``.jpf``, ``.j2c`` and ``.jpc`` as JP2, ``.j2k`` alone as a raw
codestream, as Pillow decides by the file name); BLP, MSP, XBM and Palm raise what Pillow
raises for an RGB image, and the stub formats (HDF5, GRIB, BUFR, WMF/EMF)
its "save handler not installed";
then the ``export_for_4chan`` JPEG copy (resized with Pillow's LANCZOS,
``utils/images.resize``) and the ``.txt`` sidecar, on one background writer
thread with ``sdtpu_async_save`` (``flush_saves`` joins it).  Images are
uint8 (H, W, 3|4) or grey (H, W[, 1]) numpy arrays.  Other formats
(``avif``, ...) raise ``NotImplementedError`` naming the format.

The port's PNG encoder writes every row with filter None, so its files are
not Pillow's bytes (the pixels and text chunks are the same): the
``img_downscale_threshold`` test of ``export_for_4chan`` reads the port's
file size.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from sdwebui_tpu_torch.utils import exif as exif_util
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.bmp import encode_bmp
from sdwebui_tpu_torch.utils.dds import encode_dds
from sdwebui_tpu_torch.utils.gif import encode_gif
from sdwebui_tpu_torch.utils.ico import encode_icns, encode_ico
from sdwebui_tpu_torch.utils.im import encode_im
from sdwebui_tpu_torch.utils.jpeg import encode_jpeg
from sdwebui_tpu_torch.utils.jpeg2000 import encode_jpeg2000
from sdwebui_tpu_torch.utils.netpbm import encode_netpbm
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.pcx import encode_pcx
from sdwebui_tpu_torch.utils.pdf import encode_eps, encode_pdf
from sdwebui_tpu_torch.utils.png import encode_png
from sdwebui_tpu_torch.utils.qoi import encode_qoi
from sdwebui_tpu_torch.utils.sgi import encode_sgi
from sdwebui_tpu_torch.utils.tga import encode_tga
from sdwebui_tpu_torch.utils.tiff import encode_tiff
from sdwebui_tpu_torch.utils.webp import encode_webp

_MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _mpo(image: np.ndarray, filename: str, quality: int) -> bytes:
    """One frame: Pillow's plain JPEG."""
    c = image.shape[2]
    if c in (2, 4):
        raise OSError(f"cannot write mode {_MODES[c]} as JPEG")
    return encode_jpeg(image[:, :, 0] if c == 1 else image, quality)


#: JAX's generic branch: extension → the bytes Pillow writes for
#: ``image.save(filename, format, quality=quality)``, as f(image, filename, quality)
_GENERIC = {
    "mpo": _mpo,
    "apng": lambda image, filename, quality: encode_png(image, None, level=6),  # no text
    **dict.fromkeys(("ppm", "pgm", "pbm", "pnm", "pfm"),
                    lambda image, filename, quality: encode_netpbm(image)),
    **dict.fromkeys(("tga", "icb", "vda", "vst"),
                    lambda image, filename, quality: encode_tga(image)),
    "qoi": lambda image, filename, quality: encode_qoi(image),
    **dict.fromkeys(("sgi", "rgb", "rgba", "bw"),
                    lambda image, filename, quality: encode_sgi(image, filename)),
    "pcx": lambda image, filename, quality: encode_pcx(image),
    "dds": lambda image, filename, quality: encode_dds(image),
    "im": lambda image, filename, quality: encode_im(image, filename),
    "ico": lambda image, filename, quality: encode_ico(image),
    "icns": lambda image, filename, quality: encode_icns(image),
    "pdf": lambda image, filename, quality: encode_pdf(image, quality, filename),
    **dict.fromkeys(("eps", "ps"), lambda image, filename, quality: encode_eps(image)),
    **dict.fromkeys(("jp2", "j2k", "jpx", "jpf", "j2c", "jpc"),
                    lambda image, filename, quality: encode_jpeg2000(
                        image, "j2k" if str(filename).endswith(".j2k") else "jp2")),
}
#: the extensions ``save_image`` writes
FORMATS = ("png", "jpg", "jpeg", "jfif", "jpe", "webp", "gif", "bmp", "dib", "tif",
           "tiff") + tuple(_GENERIC)
#: extensions JAX's path takes whose writer Pillow refuses for the images it
#: hands it: the error Pillow raises
PILLOW_REFUSES = {"blp": (ValueError, "Unsupported BLP image mode"),
                  "msp": (OSError, "cannot write mode {mode} as MSP"),
                  "xbm": (OSError, "cannot write mode {mode} as XBM"),
                  "palm": (OSError, "cannot write mode {mode} as Palm"),
                  "h5": (OSError, "HDF5 save handler not installed"),
                  "hdf": (OSError, "HDF5 save handler not installed"),
                  "grib": (OSError, "GRIB save handler not installed"),
                  "bufr": (OSError, "BUFR save handler not installed"),
                  "wmf": (OSError, "WMF save handler not installed"),
                  "emf": (OSError, "WMF save handler not installed")}

_INVALID_FN_CHARS = '#<>:"/\\|?*\n\r\t'


def sanitize_filename_part(text: str, replace_spaces=True) -> str:
    """Reference modules/images.py:343 semantics: invalid chars become '_',
    leading spaces and trailing ' .' are stripped, 128-char cap."""
    if text is None:
        return None
    if replace_spaces:
        text = text.replace(" ", "_")
    text = text.translate({ord(x): "_" for x in _INVALID_FN_CHARS})
    text = text.lstrip(" ")[:128]
    return text.rstrip(" .")


def check_format(extension: str, what: str = "samples_format") -> None:
    """NotImplementedError naming an image format the port cannot write.
    The extensions whose writer Pillow refuses at the write (``PILLOW_REFUSES``)
    pass, as JAX's path takes them."""
    ext = str(extension).lower().lstrip(".")
    if ext not in FORMATS and ext not in PILLOW_REFUSES:
        raise NotImplementedError(f"{what} {extension!r} is not ported yet (the port writes "
                                  f"{', '.join(FORMATS)})")


class PixelView:
    """What ``FilenameGenerator`` reads of an image: its width, height and
    raw bytes (row-major channels, as Pillow's ``tobytes()`` of the same
    image)."""

    def __init__(self, image: np.ndarray):
        self._a = np.ascontiguousarray(image)
        self.height, self.width = self._a.shape[:2]

    def tobytes(self) -> bytes:
        return self._a.tobytes()


# --------------------------------------------------------------------------
# the background writer: names are reserved synchronously (an empty
# placeholder, so numbering stays collision-free); the encode and write
# happen on one worker thread through a tmp file and os.replace;
# flush_saves() joins the queue.
# --------------------------------------------------------------------------

_save_queue = None
_save_thread = None
_save_init_lock = threading.Lock()


def _writer_loop():
    while True:
        item = _save_queue.get()
        try:
            if item is None:
                return
            item()
        except Exception:   # pragma: no cover - never kill the writer
            import traceback
            traceback.print_exc()
        finally:
            _save_queue.task_done()


def _enqueue_save(fn):
    global _save_queue, _save_thread
    import atexit
    import queue
    import threading

    with _save_init_lock:
        if _save_thread is None or not _save_thread.is_alive():
            _save_queue = queue.Queue()
            _save_thread = threading.Thread(target=_writer_loop, daemon=True)
            _save_thread.start()
            atexit.register(flush_saves)
    _save_queue.put(fn)


def flush_saves() -> None:
    """Block until every queued async save hit disk."""
    if _save_queue is not None:
        _save_queue.join()


def _write_settings() -> dict:
    """The options a write reads, taken when the save is queued: the
    request's override_settings are gone by the time the writer runs."""
    return {k: opts.get(k, d) for k, d in (("enable_pnginfo", True),
                                           ("sdtpu_png_compress_level", 1),
                                           ("jpeg_quality", 80), ("webp_lossless", False))}


def save_image_with_geninfo(image: np.ndarray, geninfo: str | None, filename: str,
                            extension: str | None = None,
                            existing_pnginfo: dict | None = None,
                            pnginfo_section_name: str = "parameters",
                            settings: dict | None = None) -> None:
    """Format-aware write with the infotext embedded (images.py:97-146): a
    PNG text chunk, a JPEG or WebP EXIF UserComment, a GIF comment.
    settings: enable_pnginfo, sdtpu_png_compress_level, jpeg_quality and
    webp_lossless (default: the options now)."""
    settings = settings or _write_settings()
    ext = (extension or os.path.splitext(filename)[1]).lower()
    if not ext.startswith("."):
        ext = "." + ext
    image = images_util.as_hwc(image)
    if ext == ".png":
        text = None
        if settings["enable_pnginfo"]:
            text = {k: str(v) for k, v in (existing_pnginfo or {}).items()}
            if geninfo is not None:
                text[pnginfo_section_name] = str(geninfo)
        data = encode_png(image, text, level=int(settings["sdtpu_png_compress_level"]))
    elif ext in (".jpg", ".jpeg"):
        pixels = image[:, :, 0] if image.shape[2] <= 2 else image[:, :, :3]
        exif = None
        if settings["enable_pnginfo"] and geninfo is not None:
            exif = exif_util.build_exif_bytes(geninfo)
        data = encode_jpeg(pixels, int(settings["jpeg_quality"]), exif)
    elif ext == ".webp":
        exif = None
        if settings["enable_pnginfo"] and geninfo is not None:
            exif = exif_util.build_exif_bytes(geninfo)
        data = encode_webp(images_util.to_rgb(image), int(settings["jpeg_quality"]),
                           bool(settings.get("webp_lossless", False)), exif)
    elif ext == ".gif":
        data = encode_gif(image, geninfo)
    elif ext in (".jfif", ".jpe"):    # Pillow's JPEG at `quality`, no infotext
        if image.shape[2] in (2, 4):
            raise ValueError(f"cannot write a {image.shape[2]}-channel image as JPEG")
        data = encode_jpeg(image[:, :, 0] if image.shape[2] == 1 else image,
                           int(settings["jpeg_quality"]))
    elif ext in (".bmp", ".dib"):
        if image.shape[2] == 2:
            raise ValueError("cannot write a grey + alpha image as BMP")
        data = encode_bmp(image, dib=ext == ".dib")
    elif ext in (".tif", ".tiff"):
        if image.shape[2] == 2:
            raise ValueError("cannot write a grey + alpha image as TIFF")
        data = encode_tiff(image)
    else:
        data = _generic(image, ext, filename, int(settings["jpeg_quality"]))
    with open(filename, "wb") as f:
        f.write(data)


def _generic(image: np.ndarray, ext: str, filename: str, quality: int) -> bytes:
    """The bytes Pillow writes for JAX's generic branch, ``image.save(filename,
    format, quality=quality)``, of the formats after PNG, JPEG, WebP, GIF,
    BMP and TIFF; ``check_format`` refuses an extension the port does not write."""
    name = ext.lstrip(".")
    if name in PILLOW_REFUSES:
        kind, msg = PILLOW_REFUSES[name]
        raise kind(msg.format(mode=_MODES[image.shape[2]]))
    check_format(name, "image format")
    return _GENERIC[name](image, filename, quality)


def save_image(image: np.ndarray, path: str, basename: str = "", seed=None, prompt=None,
               info: str | None = None, extension: str = "png", short_filename: bool = False,
               no_prompt: bool = False, grid: bool = False,
               pnginfo_section_name: str = "parameters", p=None,
               existing_info: dict | None = None, forced_filename: str | None = None,
               suffix: str = "", save_to_dirs: bool | None = None) -> str:
    """Save with the reference's naming rules and callbacks (images.py:148-299);
    returns the full path.  With opts.sdtpu_async_save the encode and write
    run on the background thread (``flush_saves`` joins it)."""
    from sdwebui_tpu_torch.scripts import framework
    from sdwebui_tpu_torch.utils.filename import FilenameGenerator, get_next_sequence_number

    height, width = np.asarray(image).shape[:2]
    namegen = FilenameGenerator(p, seed, prompt, PixelView(image), basename=basename)

    if ((height > 65535 or width > 65535) and extension.lower() in ("jpg", "jpeg")) or \
            ((height > 16383 or width > 16383) and extension.lower() == "webp"):
        extension = "png"
    check_format(extension)

    if save_to_dirs is None:
        save_to_dirs = (grid and opts.get("grid_save_to_dirs", False)) or \
            (not grid and opts.get("save_to_dirs", False) and not no_prompt)

    if save_to_dirs:
        dirname = namegen.apply(
            opts.get("directories_filename_pattern") or "[prompt_words]"
        ).lstrip(" ").rstrip("\\ /")
        path = os.path.join(path, dirname)

    os.makedirs(path, exist_ok=True)

    if forced_filename is None:
        if short_filename or seed is None:
            file_decoration = ""
        elif opts.get("save_to_dirs", False):
            file_decoration = opts.get("samples_filename_pattern") or "[seed]"
        else:
            file_decoration = opts.get("samples_filename_pattern") or "[seed]-[prompt_spaces]"

        file_decoration = namegen.apply(file_decoration) + suffix

        add_number = opts.get("save_images_add_number", True) or file_decoration == ""

        if file_decoration != "" and add_number:
            file_decoration = f"-{file_decoration}"

        if add_number:
            basecount = get_next_sequence_number(path, basename)
            fullfn = None
            for i in range(500):
                fn = f"{basecount + i:05}" if basename == "" else f"{basename}-{basecount + i:04}"
                fullfn = os.path.join(path, f"{fn}{file_decoration}.{extension}")
                if not os.path.exists(fullfn):
                    break
        else:
            fullfn = os.path.join(path, f"{file_decoration}.{extension}")
            if os.path.exists(fullfn) and \
                    opts.get("save_images_replace_action", "Replace") != "Replace":
                base_no_ext = os.path.splitext(fullfn)[0]
                n = 0
                while os.path.exists(fullfn):
                    n += 1
                    fullfn = f"{base_no_ext}-{n}.{extension}"
    else:
        fullfn = os.path.join(path, f"{forced_filename}.{extension}")

    pnginfo = dict(existing_info or {})
    if info is not None:
        pnginfo[pnginfo_section_name] = info

    # before_image_saved may swap the image or rename the file
    params = framework.ImageSaveParams(image, p, fullfn, pnginfo)
    framework.invoke("before_image_saved", params)
    image = params.image
    fullfn = params.filename
    info = params.pnginfo.get(pnginfo_section_name, None)

    fullfn_no_ext, ext = os.path.splitext(fullfn)
    if hasattr(os, "statvfs"):
        max_name_len = os.statvfs(path).f_namemax
        fullfn_no_ext = fullfn_no_ext[:max_name_len - max(4, len(ext))]
        fullfn = fullfn_no_ext + ext

    # reserve the name synchronously so concurrent numbering never collides
    open(fullfn, "wb").close()

    oversize_side = int(opts.get("target_side_length", 4000))
    downscale_mb = float(opts.get("img_downscale_threshold", 4.0))
    export_4chan = bool(opts.get("export_for_4chan", False))
    save_txt = bool(opts.get("save_txt", False))
    settings = _write_settings()

    def _write():
        tmp = fullfn_no_ext + ".tmp"
        save_image_with_geninfo(image, info, tmp, ext, existing_pnginfo=params.pnginfo,
                                pnginfo_section_name=pnginfo_section_name, settings=settings)
        os.replace(tmp, fullfn)

        h, w = np.asarray(image).shape[:2]
        oversize = w > oversize_side or h > oversize_side
        if export_4chan and (oversize or os.stat(fullfn).st_size >
                             downscale_mb * 1024 * 1024):
            ratio = w / h
            resize_to = None
            if oversize and ratio > 1:
                resize_to = (round(oversize_side), round(h * oversize_side / w))
            elif oversize:
                resize_to = (round(w * oversize_side / h), round(oversize_side))
            small = image if resize_to is None else \
                images_util.resize(images_util.to_rgb(image), resize_to, "lanczos")
            try:
                save_image_with_geninfo(small, info, fullfn_no_ext + ".jpg", settings=settings)
            except Exception:
                pass

        if save_txt and info is not None:
            with open(fullfn_no_ext + ".txt", "w", encoding="utf8") as f:
                f.write(f"{info}\n")

        framework.invoke("image_saved", params)

    if opts.get("sdtpu_async_save", True):
        image = np.array(image, copy=True)     # the writer owns its copy
        _enqueue_save(_write)
    else:
        _write()
    return fullfn


def read_info_from_image(info: dict) -> str | None:
    """The infotext of a decoded image (images.py:302): its PNG
    "parameters" text, else the UserComment of its EXIF block (a JPEG's
    APP1, a WebP's EXIF chunk, a PNG's eXIf).  A GIF's comment is not read,
    as JAX does not read it."""
    geninfo = (info or {}).get("parameters")
    if geninfo is None:
        geninfo = exif_util.read_user_comment((info or {}).get("exif"))
    return geninfo
