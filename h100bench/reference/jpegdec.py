"""Plain baseline JPEG decoder with Guetzli's pixel semantics.

The reference decodes every JPEG it judges (an input of the 4:2:0 cell,
and every output) itself. Huffman decoding, dequantization and the pixel
path are written here in Python and NumPy, from the JPEG standard
(ITU T.81, sequential DCT, Huffman) and from the reference encoder's
decoder (guetzli/output_image.cc, idct.cc, color_transform.h), whose
pixels the encoder's own butteraugli distance is measured on:

  * the 13-bit fixed-point integer IDCT of idct.cc:139-161 (the column
    pass rounded >> 11, the row pass with the +128 level shift rounded
    >> 18, clamped to 0..255);
  * a pixel cache scaled x16, and for a factor-2 chroma component the
    3x3 triangle upsample of output_image.cc:147-204 on it
    ((9 a + 3 b + 3 c + d) >> 4, the neighbour on the side of the
    pixel's parity, clamped at the subsampled plane's edge);
  * ToPixels' parity dither (p + 8 - (x & 1)) >> 4 (output_image.cc:83);
  * the integer YCbCr -> RGB of color_transform.h:1038-1046.

It takes baseline (SOF0/SOF1) three-component YCbCr images with every
component at sampling 1x1 (4:4:4), or luma 2x2 and chroma 1x1 (4:2:0).
Anything else raises JpegFormatError: the check counts it as a codec
fault. Nothing of the program is imported.
"""

import numpy as np

from h100bench.reference import consts64 as consts


class JpegFormatError(ValueError):
    pass


def _u16(data, pos):
    return (data[pos] << 8) | data[pos + 1]


class _Huffman:
    """A canonical Huffman table as a 16-bit lookup: (symbol, length)."""

    def __init__(self, counts, symbols):
        self.sym = np.zeros(1 << 16, np.int32)
        self.len = np.zeros(1 << 16, np.int32)
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if code >= (1 << length):
                    raise JpegFormatError("bad Huffman table")
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                self.sym[lo:hi] = symbols[k]
                self.len[lo:hi] = length
                code += 1
                k += 1
            code <<= 1
        self.sym = self.sym.tolist()
        self.len = self.len.tolist()


def _scan_bits(data, pos):
    """The entropy-coded segment from `pos`, byte stuffing removed, as
    bytes; and the position of the marker that ends it."""
    end = pos
    n = len(data)
    while True:
        end = data.find(b"\xff", end)
        if end < 0 or end + 1 >= n:
            raise JpegFormatError("entropy-coded segment runs off the end")
        nxt = data[end + 1]
        if nxt == 0x00 or 0xD0 <= nxt <= 0xD7:
            end += 2
            continue
        break
    return data[pos:end], end


def _decode_scan(seg, comps, mcux, mcuy, restart):
    """Decode one interleaved baseline scan into each component's
    [bh, bw, 64] int32 quantized coefficients (natural order)."""
    # Split at restart markers, then unstuff each interval.
    intervals = []
    start = 0
    i = 0
    n = len(seg)
    while i < n - 1:
        if seg[i] == 0xFF and 0xD0 <= seg[i + 1] <= 0xD7:
            intervals.append(seg[start:i])
            start = i + 2
            i += 2
            continue
        i += 1
    intervals.append(seg[start:])
    natural = consts.JPEG_NATURAL_ORDER.tolist()
    mcus_total = mcux * mcuy
    per_interval = restart if restart else mcus_total
    mcu = 0
    for chunk in intervals:
        if mcu >= mcus_total:
            break
        buf = chunk.replace(b"\xff\x00", b"\xff") + b"\x00\x00\x00\x00"
        bitpos = 0
        nbits = 8 * (len(buf) - 4)
        pred = [0] * len(comps)
        stop = min(mcus_total, mcu + per_interval)
        while mcu < stop:
            my, mx = divmod(mcu, mcux)
            for ci, c in enumerate(comps):
                dc_t, ac_t, out = c["dc"], c["ac"], c["coeffs"]
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        blk = out[my * c["v"] + by, mx * c["h"] + bx]
                        # DC
                        p = bitpos >> 3
                        peek = ((buf[p] << 16 | buf[p + 1] << 8
                                 | buf[p + 2]) >> (8 - (bitpos & 7))) \
                            & 0xFFFF
                        ln = dc_t.len[peek]
                        if ln == 0:
                            raise JpegFormatError("bad DC code")
                        s = dc_t.sym[peek]
                        bitpos += ln
                        diff = 0
                        if s:
                            p = bitpos >> 3
                            v = ((buf[p] << 24 | buf[p + 1] << 16
                                  | buf[p + 2] << 8 | buf[p + 3])
                                 >> (32 - (bitpos & 7) - s)) & ((1 << s) - 1)
                            bitpos += s
                            diff = v if v >= (1 << (s - 1)) \
                                else v - (1 << s) + 1
                        pred[ci] += diff
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            p = bitpos >> 3
                            peek = ((buf[p] << 16 | buf[p + 1] << 8
                                     | buf[p + 2]) >> (8 - (bitpos & 7))) \
                                & 0xFFFF
                            ln = ac_t.len[peek]
                            if ln == 0:
                                raise JpegFormatError("bad AC code")
                            rs = ac_t.sym[peek]
                            bitpos += ln
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break          # EOB
                                k += 16
                                continue
                            k += r
                            if k > 63:
                                raise JpegFormatError("AC run past 63")
                            p = bitpos >> 3
                            v = ((buf[p] << 24 | buf[p + 1] << 16
                                  | buf[p + 2] << 8 | buf[p + 3])
                                 >> (32 - (bitpos & 7) - s)) & ((1 << s) - 1)
                            bitpos += s
                            blk[natural[k]] = (v if v >= (1 << (s - 1))
                                               else v - (1 << s) + 1)
                            k += 1
                        if bitpos > nbits:
                            raise JpegFormatError("scan data truncated")
            mcu += 1


def parse(data):
    """JPEG bytes -> dict: width, height, sampling ("444" or "420"),
    comps: per component its [bh, bw, 64] dequantized int32 coefficients
    (natural order). Raises JpegFormatError for anything but a baseline
    three-component 4:4:4 or 4:2:0 image in one interleaved scan."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise JpegFormatError("no SOI")
    pos = 2
    qt = {}
    dc_tabs, ac_tabs = {}, {}
    frame = None
    restart = 0
    scanned = False
    while pos < len(data):
        if data[pos] != 0xFF:
            raise JpegFormatError("marker expected at %d" % pos)
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:
            break
        length = _u16(data, pos + 2)
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:
            q = 0
            while q < len(body):
                prec, idx = body[q] >> 4, body[q] & 15
                if prec:
                    vals = [_u16(body, q + 1 + 2 * i) for i in range(64)]
                    q += 129
                else:
                    vals = list(body[q + 1:q + 65])
                    q += 65
                table = np.zeros(64, np.int32)
                table[consts.JPEG_NATURAL_ORDER] = vals
                qt[idx] = table
        elif marker == 0xC4:
            q = 0
            while q < len(body):
                tc, th = body[q] >> 4, body[q] & 15
                counts = list(body[q + 1:q + 17])
                total = sum(counts)
                syms = list(body[q + 17:q + 17 + total])
                q += 17 + total
                (ac_tabs if tc else dc_tabs)[th] = _Huffman(counts, syms)
        elif marker in (0xC0, 0xC1):
            if body[0] != 8:
                raise JpegFormatError("not 8-bit")
            h, w, nc = _u16(body, 1), _u16(body, 3), body[5]
            comps = []
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
            frame = {"width": w, "height": h, "comps": comps}
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise JpegFormatError("not a baseline JPEG (SOF%d)"
                                  % (marker - 0xC0))
        elif marker == 0xDD:
            restart = _u16(body, 0)
        elif marker == 0xDA:
            if frame is None or scanned:
                raise JpegFormatError("scan before frame, or two scans")
            comps = frame["comps"]
            ns = body[0]
            if ns != len(comps) or len(comps) != 3:
                raise JpegFormatError("not one interleaved 3-component "
                                      "scan")
            samp = tuple((c["h"], c["v"]) for c in comps)
            if samp == ((1, 1), (1, 1), (1, 1)):
                frame["sampling"] = "444"
            elif samp == ((2, 2), (1, 1), (1, 1)):
                frame["sampling"] = "420"
            else:
                raise JpegFormatError("sampling %r" % (samp,))
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux = -(-frame["width"] // (8 * hmax))
            mcuy = -(-frame["height"] // (8 * vmax))
            for i in range(ns):
                cs, t = body[1 + 2 * i], body[2 + 2 * i]
                c = next(c for c in comps if c["id"] == cs)
                c["dc"], c["ac"] = dc_tabs[t >> 4], ac_tabs[t & 15]
                c["coeffs"] = np.zeros((mcuy * c["v"], mcux * c["h"], 64),
                                       np.int32)
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                raise JpegFormatError("not a sequential scan")
            seg, pos = _scan_bits(data, pos)
            _decode_scan(seg, comps, mcux, mcuy, restart)
            scanned = True
    if frame is None or not scanned:
        raise JpegFormatError("no frame or no scan")
    for c in frame["comps"]:
        c["coeffs"] = c["coeffs"] * qt[c["tq"]][None, None, :]
        del c["dc"], c["ac"]
    return frame


def _idct(coeffs):
    """[..., 64] dequantized -> [..., 8, 8] int64 pixels 0..255
    (idct.cc:139-161)."""
    m = consts.IDCT_MATRIX.astype(np.int64)          # [x, u]
    b = coeffs.reshape(coeffs.shape[:-1] + (8, 8)).astype(np.int64)
    col = np.einsum("yu,...ux->...yx", m, b)
    col = (col + (1 << 10)) >> 11
    row = np.einsum("xu,...yu->...yx", m, col)
    row = (row + (257 << 17)) >> 18
    return np.clip(row, 0, 255)


def _plane(blocks, w, h):
    """[bh, bw, 8, 8] -> [h, w] (cropped)."""
    bh, bw = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)[:h, :w]


def _dither(pix16):
    x = np.arange(pix16.shape[-1])
    return (pix16 + (8 - (x & 1))) >> 4


def _upsample(sub, w, h):
    """x16 subsampled plane [hs, ws] -> [h, w] x16 (output_image.cc:
    147-204)."""
    hs, ws = sub.shape
    x = np.arange(w)
    y = np.arange(h)
    cx, cy = x >> 1, y >> 1
    cx2 = np.clip(cx + (x & 1) * 2 - 1, 0, ws - 1)
    cy2 = np.clip(cy + (y & 1) * 2 - 1, 0, hs - 1)
    r1 = sub[cy, :]
    r2 = sub[cy2, :]
    return (9 * r1[:, cx] + 3 * r1[:, cx2] + 3 * r2[:, cx]
            + r2[:, cx2]) >> 4


def to_rgb(frame):
    """The decoded image, uint8 [h, w, 3]."""
    w, h = frame["width"], frame["height"]
    ycc = []
    for i, c in enumerate(frame["comps"]):
        pix16 = _idct(c["coeffs"]) << 4
        if frame["sampling"] == "420" and i > 0:
            sub = _plane(pix16, (w + 1) // 2, (h + 1) // 2)
            ycc.append(_dither(_upsample(sub, w, h)))
        else:
            ycc.append(_dither(_plane(pix16, w, h)))
    y, cb, cr = ycc
    r = y + ((91881 * (cr - 128) + 32768) >> 16)
    b = y + ((116130 * (cb - 128) + 32768) >> 16)
    g = y + (((-46802) * (cr - 128) + (-22554) * (cb - 128) + 32768) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode(data):
    """JPEG bytes -> (rgb uint8 [h, w, 3], sampling "444" or "420")."""
    frame = parse(data)
    return to_rgb(frame), frame["sampling"]
