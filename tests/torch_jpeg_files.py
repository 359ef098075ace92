"""JPEG files in the sampling modes the port never writes, for decoder tests
and codec timings: the port's encoder core (``utils/jpeg._encode_ycc``)
with libjpeg's other downsamplers (``jcsample.c``).  4:4:4 and 4:2:2 are
Pillow's ``subsampling=0`` and ``1``, byte for byte; 4:4:0 (luma sampled 1×2)
is no Pillow setting.  numpy only, so that it also runs where Pillow is
absent."""

import numpy as np

from sdwebui_tpu_torch.utils import jpeg


def _fullsize(plane: np.ndarray) -> np.ndarray:
    return plane


def _h2v1(plane: np.ndarray) -> np.ndarray:
    """h2v1_downsample: the mean of each pair along a row, biased 0, 1, 0, 1."""
    p = plane.astype(np.int64)
    bias = np.arange(p.shape[1] // 2, dtype=np.int64) & 1
    return ((p[:, 0::2] + p[:, 1::2] + bias) >> 1).astype(np.uint8)


def _h1v2(plane: np.ndarray) -> np.ndarray:
    """int_downsample over 1×2: the rounded mean of each pair of rows."""
    p = plane.astype(np.int64)
    return ((p[0::2] + p[1::2] + 1) >> 1).astype(np.uint8)


#: Pillow's subsampling names → (the luma's sampling factors, the chroma's
#: downsampler); "4:4:0" is no Pillow setting
MODES = {"4:4:4": ((1, 1), _fullsize), "4:2:2": ((2, 1), _h2v1),
         "4:2:0": ((2, 2), jpeg._h2v2_downsample), "4:4:0": ((1, 2), _h1v2)}


def encode_sampled(image: np.ndarray, quality: int, subsampling: str,
                   exif: bytes | None = None) -> bytes:
    """uint8 (H, W, 3) RGB → baseline JPEG bytes in `subsampling`."""
    factors, downsample = MODES[subsampling]
    return jpeg._encode_ycc(jpeg._checked(image), quality, exif, factors, downsample)
