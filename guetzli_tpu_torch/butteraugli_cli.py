"""Standalone butteraugli distance CLI (port of
guetzli_tpu/butteraugli_cli.py, the analog of the reference's
third_party/butteraugli/butteraugli_main.cc).

  python -m guetzli_tpu_torch.butteraugli_cli [--cpu] image1 image2 [heatmap.pgm]

Prints the butteraugli distance between two PNG or JPEG images of the same
size; optionally writes the per-pixel diffmap as a PGM heatmap. Runs on
the CUDA device; --cpu runs on the CPU instead. Without a card and
without --cpu it exits 1 with a message.
"""

import sys

import numpy as np
import torch

_USAGE = ("Usage: python -m guetzli_tpu_torch.butteraugli_cli [--cpu] "
          "{image1} {image2} [heatmap.pgm]\n")


def _load_image(path):
    """(rgb uint8 [h, w, 3], w, h) of a PNG or JPEG file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        from guetzli_tpu_torch.codec import reader
        from guetzli_tpu_torch.search.processor import decode_jpeg_to_rgb
        jpg = reader.read_jpeg(data)
        rgb = decode_jpeg_to_rgb(jpg)
        if rgb is None:
            raise ValueError("unsupported JPEG: %s" % path)
        return rgb, jpg.width, jpg.height
    from guetzli_tpu_torch.io.png import read_png
    return read_png(data)


def compute_distance(rgb0, rgb1, w, h, device):
    """(distance, diffmap [h, w] numpy) between two uint8 [h, w, 3] images,
    on `device`: the whole-image opsin of each, then the diffmap and its
    score."""
    from guetzli_tpu_torch import consts
    from guetzli_tpu_torch.ops import diffmap as dm
    from guetzli_tpu_torch.ops.opsin import opsin_dynamics_image

    lut = consts.SRGB_TO_LINEAR.astype(np.float32)

    def xyb(rgb):
        lin = np.ascontiguousarray(lut[rgb].transpose(2, 0, 1))
        return opsin_dynamics_image(torch.as_tensor(lin, device=device))

    dmap = dm.diffmap_opsin_dynamics(xyb(rgb0), xyb(rgb1))
    return float(dm.score_from_diffmap(dmap)), dmap.cpu().numpy()


def _write_heatmap(path, dmap):
    """Grayscale PGM of the diffmap scaled to its max."""
    h, w = dmap.shape
    peak = max(float(dmap.max()), 1e-9)
    img = np.clip(dmap / peak * 255.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if argv and argv[0] == "--cpu":
        device = "cpu"
        argv = argv[1:]
    if len(argv) not in (2, 3):
        sys.stderr.write(_USAGE)
        return 1
    from guetzli_tpu_torch.device import resolve
    try:
        dev = resolve(device)
    except RuntimeError as e:
        sys.stderr.write("%s\n" % e)
        return 1
    rgb0, w0, h0 = _load_image(argv[0])
    rgb1, w1, h1 = _load_image(argv[1])
    if (w0, h0) != (w1, h1):
        sys.stderr.write("Images must have the same size\n")
        return 1
    distance, dmap = compute_distance(rgb0, rgb1, w0, h0, dev)
    print("%.6f" % distance)
    if len(argv) == 3:
        _write_heatmap(argv[2], dmap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
