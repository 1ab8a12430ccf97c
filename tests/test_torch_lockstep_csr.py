"""The combined zeroing call of the port's lockstep corpus encoder
(guetzli_tpu_torch/parallel/lockstep._corpus_masking) against the JAX
package's compute_zeroing_csr_staged, on the CPU, one torch thread.

A two-image corpus (two geometries, two error limits) goes through
_corpus_masking, whose one zeroing call over the concatenated blocks
(per-block limits, real_index) is captured. JAX, run op by op
(jax.disable_jit: the same float32 operations in the same order, see
test_torch_zeroing.py), computes the CSR of the same concatenated inputs
on the JAX comparators' frozen state, which the port's comparators carry
(interop.py). The CSR must be equal bit for bit in modes 444, 420y and
420c.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu.codec.encoder import encode_rgb_to_jpeg as jencode
from guetzli_tpu.comparator import Comparator as JComparator
from guetzli_tpu.ops import tiles_lanes as jtl
from guetzli_tpu.search import processor as jproc
from guetzli_tpu.search import state as jst
from guetzli_tpu.search import zeroing as jz

from guetzli_tpu_torch import interop
from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
from guetzli_tpu_torch.io.png import read_png
from guetzli_tpu_torch.ops import image as img_ops
from guetzli_tpu_torch.parallel import lockstep
from guetzli_tpu_torch.search import processor as proc_mod
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search import zeroing as tz


@pytest.fixture
def jax_srgb(monkeypatch):
    """Both sides read JAX's 256 sRGB->linear values (one ulp of pow
    differs, see test_torch_tiles_lanes.py)."""
    lut = np.array(jtl._srgb_to_linear_lanes(
        jnp.arange(256, dtype=jnp.int32)))
    monkeypatch.setattr(img_ops, "srgb_table",
                        lambda device: torch.as_tensor(lut).to(device))
    monkeypatch.setenv("GUETZLI_TPU_ZEROING_FUSED", "0")


# mode -> (comp_mask, the JAX package's staged mode)
MODES = {"444": (7, "444l"), "420y": (1, "420yl"), "420c": (6, "420cl")}
# Two crops of bees97x63 (two geometries), each with its own error limit,
# at quant 8 (Y) and 16 (chroma), thinned to few zeroing candidates a
# block: op-by-op JAX costs ~1-7 s per greedy step.
CROPS = (((48, 32), 2.0), ((40, 40), 3.0))
QUANT = np.repeat(np.array([8, 16, 16], np.int32)[:, None], 64, axis=1)
# mode -> nonzero AC coefficients kept per block of Y, Cb and Cr: few in
# the channels of the pass, all in the frozen ones.
KEEP = {"444": (2, 1, 1), "420y": (2, 64, 64), "420c": (64, 1, 1)}


class _Stop(Exception):
    pass


def _thin(img, mode):
    """Zero every AC coefficient of a block past its channel's first KEEP
    nonzero ones (in place, a CoeffImage of either package)."""
    for c, keep in zip(img.comps, KEEP[mode]):
        ac = c.coeffs[:, 1:]
        nz = np.cumsum(ac != 0, axis=1)
        ac[nz > keep] = 0


def _image(rgb, w, h, target, mode):
    """(port Processor, jpg, img) on a comparator that carries the JAX
    comparator's frozen state, the JAX image's coefficients equal."""
    mask = MODES[mode][0]
    jcomp = JComparator(rgb, w, h, target, padded=False)
    jjpg = jencode(rgb, w, h)
    jst.remove_original_quantization(jjpg)
    jimg = jst.CoeffImage.from_jpeg(jjpg)
    jpg = encode_rgb_to_jpeg(rgb, w, h)
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    if mask != 7:
        jimg.downsample()
        img.downsample()
        jpg = img.save_to_jpeg_data(jpg)
    for i in (jimg, img):
        i.apply_global_quantization(QUANT)
        _thin(i, mode)
    for a, b in zip(jimg.comps, img.comps):
        np.testing.assert_array_equal(a.coeffs, b.coeffs)
    grid = jimg.comps[mask.bit_length() - 1]
    jmode, aux = jproc.Processor(jproc.Params(), jcomp, jproc.ProcessStats()) \
        .masking_aux(jimg, mask, grid)
    assert jmode in ("444", "444l", MODES["420y"][1], MODES["420c"][1])
    aux = tuple(np.asarray(a) for a in aux)
    if mask == 7:
        state = dict(block_state=aux)
    elif mask == 1:
        state = dict(block_state=aux[1:],
                     frozen_420={"chroma_bytes": aux[0]})
    else:
        state = dict(frozen_420={"neighborhoods": aux[:2], "y16": aux[2],
                                 "children": aux[3:]})
    comp = interop.comparator_state_from_numpy(
        rgb, w, h, target, np.asarray(jcomp.xyb0), **state)
    return proc_mod.Processor(proc_mod.Params(), comp,
                              proc_mod.ProcessStats()), jpg, img


@pytest.mark.parametrize("mode", sorted(MODES))
def test_combined_csr_vs_jax_op_by_op(mode, jax_srgb, monkeypatch):
    mask, jmode = MODES[mode]
    rgb, _w, _h = read_png((FIXTURES / "bees97x63.png").read_bytes())
    trip = [_image(np.ascontiguousarray(rgb[:h, :w]), w, h, t, mode)
            for (w, h), t in CROPS]
    seen = {}
    real = tz.compute_zeroing_csr

    def capture(*a, **k):
        seen.update(args=a, kw=k, out=real(*a, **k))
        raise _Stop
    monkeypatch.setattr(tz, "compute_zeroing_csr", capture)
    with pytest.raises(_Stop):
        lockstep._corpus_masking(trip, mask, [1.0, 1.0], mask == 6)
    blocks, orig, limits, aux, got_mask, _dev = seen["args"]
    kw = seen["kw"]
    assert (got_mask, kw["mode"]) == (mask, mode)
    nbs = [len(p.masking_inputs(j, i, mask)[0]) for p, j, i in trip]
    np.testing.assert_array_equal(
        limits, np.repeat(np.float32([t for _c, t in CROPS]), nbs))
    np.testing.assert_array_equal(kw["real_index"], np.arange(sum(nbs)))
    n_cand = ((blocks != 0).sum(axis=2) - (blocks[:, :, 0] != 0)).sum(1)
    assert n_cand.max() == {"444": 4, "420y": 2, "420c": 2}[mode]
    with jax.disable_jit():
        want = jz.compute_zeroing_csr_staged(
            blocks, orig, limits,
            tuple(jnp.asarray(a.numpy()) for a in aux), jmode, mask,
            real_index=kw["real_index"])
    for name, w, g in zip(("offsets", "cand_idx", "cand_err"), want,
                          seen["out"]):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert len(seen["out"][1]) > 0


