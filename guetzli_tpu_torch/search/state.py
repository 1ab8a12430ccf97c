"""Mutable encoder image state: dequantized DCT coefficients + quant.

Port of guetzli_tpu/search/state.py (guetzli/output_image.{h,cc}):
instead of an incrementally maintained x16 pixel cache updated on every
SetCoeffBlock (output_image.cc:124-133), the state is the per-component
coefficient arrays (numpy, on the host); pixels are rebuilt on the device
from all coefficients at once whenever the metric needs them.

Coefficients are kept *dequantized* (multiples of the quant values), same
as OutputImageComponent::coeffs_.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np

from guetzli_tpu_torch.codec import jpeg_data as jd


def quantize(coeff, quant):
    """Round to nearest multiple (guetzli/quantize.h), C truncation.

    Works on |coeff|: for m = |c| % q the signed-delta cases collapse to
    |out| = |c| + (q - m if 2m > q else -m), out = sign(c) * |out| --
    identical to the reference's signed-remainder form but in int32
    (values are bounded by the 4096 sanity gate) with ~half the
    temporaries; this runs once per accepted quant-search iteration over
    every coefficient, ~0.5 s/MPix/call in the int64 form."""
    c = np.asarray(coeff, dtype=np.int32)
    q = np.asarray(quant, dtype=np.int32)
    qv = q.reshape(-1)
    if (c.ndim == 2 and c.shape[1] == 64 and qv.shape[0] == 64
            and c.flags.c_contiguous):
        from guetzli_tpu_torch import native
        lib = native.get_lib()
        if lib is not None:
            import ctypes
            out = c.copy()
            qc = np.ascontiguousarray(qv)
            lib.gt_quantize_blocks(
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                qc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_int64(out.shape[0]))
            return out
    a = np.abs(c)
    m = a % q
    out = a + np.where(m + m > q, q - m, -m)
    np.negative(out, where=c < 0, out=out)
    return out


@dataclass
class ComponentState:
    """OutputImageComponent: one channel's coefficient grid."""
    factor_x: int
    factor_y: int
    bw: int                 # width_in_blocks
    bh: int                 # height_in_blocks
    coeffs: np.ndarray      # int32 [bw*bh, 64], dequantized
    quant: np.ndarray       # int32 [64]

    @classmethod
    def reset(cls, width, height, factor_x, factor_y):
        bw = (width + 8 * factor_x - 1) // (8 * factor_x)
        bh = (height + 8 * factor_y - 1) // (8 * factor_y)
        return cls(factor_x, factor_y, bw, bh,
                   np.zeros((bw * bh, 64), dtype=np.int32),
                   np.ones(64, dtype=np.int32))

    def is_all_zero(self):
        return not np.any(self.coeffs)

    def copy(self):
        return ComponentState(self.factor_x, self.factor_y, self.bw,
                              self.bh, self.coeffs.copy(),
                              self.quant.copy())


@dataclass
class CoeffImage:
    """OutputImage: width/height + three component states."""
    width: int
    height: int
    comps: List[ComponentState] = field(default_factory=list)

    # -- constructors -------------------------------------------------

    @classmethod
    def from_jpeg(cls, jpg: jd.JpegData) -> "CoeffImage":
        """OutputImage::CopyFromJpegData: dequantize per component."""
        img = cls(jpg.width, jpg.height)
        for c in jpg.components:
            factor_x = jpg.max_h_samp_factor // c.h_samp_factor
            factor_y = jpg.max_v_samp_factor // c.v_samp_factor
            comp = ComponentState.reset(jpg.width, jpg.height,
                                        factor_x, factor_y)
            q = jpg.quant[c.quant_idx].values.astype(np.int32)
            # Component may carry more blocks than the output grid (MCU
            # padding); copy the covered sub-grid (output_image.cc:212-228).
            src = c.coeffs.reshape(c.height_in_blocks, c.width_in_blocks, 64)
            sub = src[:comp.bh, :comp.bw].reshape(-1, 64)
            comp.coeffs = sub.astype(np.int32) * q[None, :]
            comp.quant = q.copy()
            img.comps.append(comp)
        # The reference's OutputImage always carries three components; a
        # grayscale-collapsed jpg (1 component) leaves chroma all-zero at
        # factor 1 (output_image.cc:205-228 only fills present ones).
        while len(img.comps) < 3:
            img.comps.append(ComponentState.reset(jpg.width, jpg.height,
                                                  1, 1))
        return img

    def copy(self) -> "CoeffImage":
        return CoeffImage(self.width, self.height,
                          [c.copy() for c in self.comps])

    # -- properties ---------------------------------------------------

    def is_444(self):
        return all(c.factor_x == 1 and c.factor_y == 1 for c in self.comps)

    @property
    def bw(self):
        return self.comps[0].bw

    @property
    def bh(self):
        return self.comps[0].bh

    @property
    def coeffs(self):
        """[3, NB, 64] stacked view for the 444 fast path."""
        assert self.is_444()
        return np.stack([c.coeffs for c in self.comps])

    @coeffs.setter
    def coeffs(self, value):
        assert self.is_444()
        for i, c in enumerate(self.comps):
            c.coeffs = np.asarray(value[i], dtype=np.int32)

    @property
    def quant(self):
        return np.stack([c.quant for c in self.comps])

    @quant.setter
    def quant(self, value):
        for i, c in enumerate(self.comps):
            c.quant = np.asarray(value[i], dtype=np.int32)

    # -- mutation -----------------------------------------------------

    def apply_global_quantization(self, q) -> None:
        """OutputImage::ApplyGlobalQuantization (output_image.cc:349-360)."""
        q = np.asarray(q, dtype=np.int32).reshape(3, 64)
        for i, c in enumerate(self.comps):
            c.coeffs = quantize(c.coeffs, q[i][None, :])
            c.quant = q[i].copy()

    def downsample(self, use_silver_screen=False) -> None:
        """OutputImage::Downsample (output_image.cc:535-571), YUV420, on
        the host. The silver-screen branch rebuilds the sRGB bytes with the
        integer pixel path (ops/image.coeffs_to_srgb, on the CPU)."""
        import torch

        from guetzli_tpu_torch.ops import image as img_ops
        from guetzli_tpu_torch.search import downsample as ds
        if self.comps[1].is_all_zero() and self.comps[2].is_all_zero():
            return
        if use_silver_screen:
            srgb = img_ops.coeffs_to_srgb(
                torch.as_tensor(self.coeffs), self.bw, self.bh,
                self.width, self.height).numpy()
            rgb = srgb.transpose(1, 2, 0).astype(np.uint8)
            yuv = ds.rgb_to_yuv420(rgb, self.width, self.height)
            planes = [np.asarray(p, np.float32).reshape(
                self.height, self.width) for p in yuv]
            for ci, (fx, fy) in ((0, (1, 1)), (1, (2, 2)), (2, (2, 2))):
                coeffs, _bw, _bh = ds.downsampled_coefficients(
                    planes[ci], fx, fy)
                comp = ComponentState.reset(self.width, self.height, fx, fy)
                comp.coeffs = coeffs.astype(np.int32)
                self.comps[ci] = comp
            return
        yuv = np.stack([
            ds.to_float_pixels(c.coeffs, c.bw, c.bh, self.width,
                               self.height)
            for c in self.comps])
        yuv = ds.preprocess_channel(self.width, self.height, 2, 1.3, 0.5,
                                    True, True, yuv)
        yuv = ds.preprocess_channel(self.width, self.height, 1, 1.3, 0.5,
                                    True, True, yuv)
        for ci in (1, 2):
            coeffs, _bw, _bh = ds.downsampled_coefficients(yuv[ci], 2, 2)
            comp = ComponentState.reset(self.width, self.height, 2, 2)
            comp.coeffs = coeffs.astype(np.int32)
            self.comps[ci] = comp

    # -- serialization ------------------------------------------------

    def save_to_jpeg_data(self, jpg_template: jd.JpegData) -> jd.JpegData:
        """OutputImage::SaveToJpegData (output_image.cc:579-640): divide by
        quant, grayscale collapse, MCU-grid padding blocks with DC
        propagation, fresh quant tables."""
        y = self.comps[0]
        assert y.factor_x == 1 and y.factor_y == 1
        jpg = jd.JpegData(
            width=self.width, height=self.height,
            max_h_samp_factor=1, max_v_samp_factor=1,
            MCU_cols=y.bw, MCU_rows=y.bh,
            app_data=list(jpg_template.app_data),
            com_data=list(jpg_template.com_data),
            tail_data=jpg_template.tail_data)
        ncomp = 1 if (self.comps[1].is_all_zero()
                      and self.comps[2].is_all_zero()) else 3
        for i in range(1, ncomp):
            c = self.comps[i]
            jpg.max_h_samp_factor = max(jpg.max_h_samp_factor, c.factor_x)
            # Reference quirk (output_image.cc:592): the v field maxes
            # against max_h_samp_factor, not max_v.
            jpg.max_v_samp_factor = max(jpg.max_h_samp_factor, c.factor_y)
            jpg.MCU_cols = min(jpg.MCU_cols, c.bw)
            jpg.MCU_rows = min(jpg.MCU_rows, c.bh)
        for ci in range(ncomp):
            c = self.comps[ci]
            comp = jd.Component(id=ci)
            comp.h_samp_factor = jpg.max_h_samp_factor // c.factor_x
            comp.v_samp_factor = jpg.max_v_samp_factor // c.factor_y
            comp.width_in_blocks = jpg.MCU_cols * comp.h_samp_factor
            comp.height_in_blocks = jpg.MCU_rows * comp.v_samp_factor
            qc = c.quant
            # Invariant tripwire (output_image.cc:600 debug assert):
            # sampled above 4k blocks -- a full modulo pass per save is
            # measurable at MPix scale.
            nbc = c.coeffs.shape[0]
            probe = c.coeffs[::max(1, nbc // 4096)]
            assert not np.any(probe % qc[None, :]), \
                "coefficients must be multiples of the quant matrix"
            quantized = (c.coeffs // qc[None, :]).astype(np.int16)
            src = quantized.reshape(c.bh, c.bw, 64)
            dst = np.zeros((comp.height_in_blocks, comp.width_in_blocks,
                            64), dtype=np.int16)
            hh = min(c.bh, comp.height_in_blocks)
            ww = min(c.bw, comp.width_in_blocks)
            dst[:hh, :ww] = src[:hh, :ww]
            if comp.width_in_blocks > c.bw:
                # Pad columns: propagate the previous block's DC
                # (output_image.cc:617-637, raster-order last_dc).
                for bx in range(c.bw, comp.width_in_blocks):
                    dst[:, bx, 0] = dst[:, bx - 1, 0]
            if comp.height_in_blocks > c.bh:
                for by in range(c.bh, comp.height_in_blocks):
                    # last_dc after finishing previous row is its last
                    # block's DC.
                    dst[by, :, 0] = dst[by - 1, -1, 0]
            comp.coeffs = dst.reshape(-1, 64)
            jpg.components.append(comp)
        jd.save_quant_tables(self.quant[:ncomp], jpg)
        return jpg

    def update_jpeg_data(self, jpg_out: jd.JpegData, changed, channels,
                         bw: int) -> None:
        """Incremental SaveToJpegData: requantize only the blocks the
        back-end flips changed, in place on a previously saved jpg_out.

        Valid only while the grayscale-collapse state cannot change (DC
        coefficients are never flip candidates, so the MCU padding blocks
        -- whose AC is zero and whose DC propagates from real blocks --
        stay correct without touching them).

        Args:
          jpg_out: a JpegData previously produced by save_to_jpeg_data
            for this image (mutated in place).
          changed: int array of changed block indexes on the (bw, bh)
            pass grid (the same grid the flip loop indexes).
          channels: iterable of channel indexes the pass may flip.
          bw: the pass grid's blocks-per-row.
        """
        if len(changed) == 0:
            return
        rows = changed // bw
        cols = changed % bw
        for ci in channels:
            if ci >= len(jpg_out.components):
                continue
            c = self.comps[ci]
            jcomp = jpg_out.components[ci]
            jix = rows * jcomp.width_in_blocks + cols
            jcomp.coeffs[jix] = (
                c.coeffs[changed] // c.quant[None, :]).astype(np.int16)


def remove_original_quantization(jpg: jd.JpegData):
    """processor.cc:94-107: fold quant into coefficients, reset to ones.

    Returns the original quant matrices [3, 64] int32.
    """
    q_in = np.zeros((3, 64), dtype=np.int32)
    for i, c in enumerate(jpg.components):
        q = jpg.quant[c.quant_idx].values.astype(np.int32)
        q_in[i] = q
        # Reference stores the product back into int16 coeff_t; inputs are
        # sanity-checked to |coeff*quant| <= 4096 so this never overflows.
        c.coeffs = (c.coeffs.astype(np.int32) * q[None, :]).astype(np.int16)
    ones = np.ones((len(jpg.components), 64), dtype=np.int32)
    jd.save_quant_tables(ones, jpg)
    return q_in
