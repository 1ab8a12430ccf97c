"""Library entry points: encode one PNG or JPEG to a perceptual JPEG
(encode_bytes), or a corpus of them one image at a time (encode_corpus).

Port of guetzli_tpu/parallel/api.py. The corpus path that runs the
search of every image in phase is parallel/lockstep.py.
"""

import dataclasses
import struct
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from guetzli_tpu_torch import consts, runtime
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
    return _encode(data, None, quality, params, stats, resolve(device))


def _encode(data, pixels, quality, params, stats, dev):
    """encode_bytes on `dev`; pixels: the PNG's read_png result when
    decoded already, else None."""
    params = params or Params()
    params.butteraugli_target = consts.butteraugli_score_for_quality(quality)
    stats = stats or ProcessStats()
    if is_jpeg(data):
        out = process_jpeg_bytes(params, data, stats, dev)
        if out is None:
            raise ValueError("JPEG input could not be processed")
        return out
    with stats.timed("image_setup"), stats.timed("input_decode"):
        rgb, w, h = read_png(data) if pixels is None else pixels
    return process_rgb(params, rgb, w, h, stats, dev)


def _decode(data):
    """The host decode that may run ahead of an encode: a PNG's pixels
    (read_png); None for a JPEG, whose reader is the encode's own."""
    return None if is_jpeg(data) else read_png(data)


def _peek_geometry(data: bytes):
    """(w, h) from the JPEG's SOF or the PNG's IHDR, or None."""
    if is_jpeg(data):
        from guetzli_tpu_torch.codec.reader import peek_dimensions
        return peek_dimensions(data)
    if data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR":
        return struct.unpack(">II", data[16:24])
    return None


def encode_corpus(inputs, quality: float = 95, params: Params = None,
                  verbose: bool = False, threads: int = 1, device=None):
    """Encode a corpus of images one at a time (the serial analog of the
    reference's one process per image).

    inputs: (name, bytes) pairs, encoded in the order of their geometry.
    With `threads` > 1 a pool of that many threads decodes the PNGs
    ahead of their encodes, while the encodes themselves run one at a
    time on the calling thread: no compare or kernel is issued from a
    pool thread, and the bytes are those of threads=1. A failed image is
    recorded as None after a message on stderr and the corpus goes on,
    unless the error is sticky (runtime.is_sticky): the device is lost
    and the error propagates. Runs on the CUDA device unless `device`
    says otherwise ("cpu"). Returns [(name, jpeg_bytes or None,
    seconds)] in input order."""
    dev = resolve(device)
    items = list(inputs)
    geoms = [_peek_geometry(d) for _, d in items]
    order = sorted(range(len(items)),
                   key=lambda i: (geoms[i] is None, geoms[i] or (0, 0),
                                  len(items[i][1])))
    results = [None] * len(items)

    def encode_one(i, decoded):
        name, data = items[i]
        t0 = time.time()
        try:
            out = _encode(data, decoded(), quality,
                          dataclasses.replace(params) if params else None,
                          None, dev)
        except Exception as e:
            if runtime.is_sticky(e):
                raise
            sys.stderr.write("%s: %s\n" % (name, e))
            out = None
        dt = time.time() - t0
        if verbose:
            sys.stderr.write("%s: %d bytes in %.1fs\n"
                             % (name, len(out) if out else 0, dt))
        results[i] = (name, out, dt)

    if threads <= 1:
        for i in order:
            encode_one(i, lambda: None)
        return results
    with ThreadPoolExecutor(max_workers=threads) as pool:
        ahead = {}
        for k, i in enumerate(order):
            for j in order[k:k + threads]:
                if j not in ahead:
                    ahead[j] = pool.submit(_decode, items[j][1])
            encode_one(i, ahead.pop(i).result)
    return results
