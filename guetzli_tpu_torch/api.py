"""Library entry point: encode one PNG or JPEG to a perceptual JPEG.

Port of guetzli_tpu/parallel/api.py::encode_bytes.
"""

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.device import resolve
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.search.processor import (Params, ProcessStats,
                                                process_jpeg_bytes,
                                                process_rgb)


def is_jpeg(data: bytes) -> bool:
    return data[:2] == b"\xff\xd8"


def encode_bytes(data: bytes, quality: float = 95, params: Params = None,
                 stats: ProcessStats = None, device=None) -> bytes:
    """Encode PNG or JPEG bytes; returns the JPEG bytes.

    A JPEG input is searched from its own coefficients (4:4:4 or 4:2:0,
    baseline or progressive); any other JPEG the reader parses (grayscale,
    CMYK/YCCK, 4:2:2) is decoded to pixels and encoded from them.
    Runs on the CUDA device unless `device` says otherwise ("cpu" to run
    on the CPU); raises RuntimeError when no GPU is present and the CPU
    was not asked for. Raises ValueError for undecodable input or a
    quality below 84."""
    dev = resolve(device)
    params = params or Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(quality)
    stats = stats or ProcessStats()
    if is_jpeg(data):
        out = process_jpeg_bytes(params, data, stats, dev)
        if out is None:
            raise ValueError("JPEG input could not be processed")
        return out
    rgb, w, h = read_png(data)
    return process_rgb(params, rgb, w, h, stats, dev)
