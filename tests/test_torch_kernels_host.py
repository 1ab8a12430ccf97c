"""The CUDA kernels' source, compiled for the host, against their plain
PyTorch versions on the CPU.

The kernels of guetzli_tpu_torch/csrc run only on the card (chip_smoke.py
and the gpu-marked test hold them there). Their logic -- the operand
layouts, the three modes' pixel stages, the greedy loop -- is plain C++
apart from a few CUDA keywords, so this test compiles the same sources
with g++ behind a small shim (the keywords defined away, each launch
``k<<<grid, threads, ...>>>(args)`` rewritten as a loop over the grid
that runs the kernel once per (block, thread)) and calls the same C entry
points on CPU tensors. The loop runs the grid twice: a block's threads
run one after another here, so the first pass only fills the shared
table each thread loads its share of.

With -ffp-contract=off (the card's build uses --fmad=false) and IEEE
division and sqrt on both sides, the host-built kernels equal the plain
versions bit for bit: compares on every lane, greedy rails on every block.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import consts
from guetzli_tpu_torch.codec import reader
from guetzli_tpu_torch.comparator import Comparator
from guetzli_tpu_torch.kernels import build, tables
from guetzli_tpu_torch.kernels import tile_compare as kc
from guetzli_tpu_torch.kernels import tile_compare_lanes as ka
from guetzli_tpu_torch.kernels import zeroing_loop as zl
from guetzli_tpu_torch.ops import tiles_lanes as tl
from guetzli_tpu_torch.search import state as st
from guetzli_tpu_torch.search import zeroing
from guetzli_tpu_torch.search.processor import (Params, Processor,
                                                decode_jpeg_to_rgb)

CPU = torch.device("cpu")
CORPUS = FIXTURES.parent / "corpus"

_SHIM = """#pragma once
#include <cmath>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(x)
struct dim3v { unsigned x, y, z; };
static dim3v threadIdx, blockIdx, blockDim;
inline void __syncthreads() {}
typedef struct CUstream_st* cudaStream_t;
inline int cudaGetLastError() { return 0; }
struct float3 { float x, y, z; };
inline float3 make_float3(float x, float y, float z) {
  return float3{x, y, z};
}
"""


def _split_top(s):
    """Split at the commas outside parentheses."""
    out, depth, cur = [], 0, ""
    for ch in s:
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
            continue
        depth += (ch == "(") - (ch == ")")
        cur += ch
    return out + [cur.strip()]


def _host_source(text):
    def launch(m):
        grid, threads = _split_top(m.group(2))[:2]
        return ("for (int _p = 0; _p < 2; ++_p) "
                "for (unsigned _b = 0; _b < (unsigned)(%s); ++_b) "
                "for (unsigned _t = 0; _t < (unsigned)(%s); ++_t) { "
                "blockIdx.x = _b; threadIdx.x = _t; blockDim.x = %s; %s("
                % (grid, threads, threads, m.group(1)))
    text, n = re.subn(r"(\w+)<<<(.*?)>>>\(", launch, text, flags=re.S)
    assert n >= 1
    # Close the loop body after the launch statement.
    return re.sub(r"(blockDim\.x = [^;]*; \w+\([^;]*?\);)", r"\1 }", text,
                  flags=re.S)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """library name -> ctypes handle of the host build of its source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources for the host")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / "math_constants.h").write_text(
        "#pragma once\n#define CUDART_INF_F __builtin_inff()\n")
    procs = {}
    for lib, src in build.SOURCES.items():
        cpp = d / (lib + ".cpp")
        cpp.write_text(_host_source((build.CSRC / src).read_text()))
        procs[lib] = subprocess.Popen(
            [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
             "-shared", "-I", str(d), "-I", str(build.CSRC), "-o",
             str(d / ("lib%s.so" % lib)), str(cpp)],
            stderr=subprocess.PIPE, text=True)
    for lib, p in procs.items():
        _out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return {lib: ctypes.CDLL(str(d / ("lib%s.so" % lib)))
            for lib in build.SOURCES}


def _entry(libs, name):
    lib, fname, argtypes = build.SIGNATURES[name]
    fn = getattr(libs[lib], fname)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def states():
    """mode -> (blocks, aux, comp_mask): bees_d.jpg's 4:4:4 pass and
    bees_d-420.jpg's two 4:2:0 passes (97x63: the last macroblock column
    has invalid children), quantized coarser than the files so the greedy
    loops stay short."""
    out = {}
    for name, masks, q in (("bees_d.jpg", (7,), (12, 12, 12)),
                           ("bees_d-420.jpg", (1, 6), (10, 16, 16))):
        jpg = reader.read_jpeg((CORPUS / name).read_bytes())
        rgb = decode_jpeg_to_rgb(jpg)
        comp = Comparator(rgb, jpg.width, jpg.height,
                          consts.butteraugli_score_for_quality(95), CPU)
        st.remove_original_quantization(jpg)
        img = st.CoeffImage.from_jpeg(jpg)
        img.apply_global_quantization(
            np.repeat(np.array(q, np.int32)[:, None], 64, axis=1))
        proc = Processor(Params(), comp, None)
        for mask in masks:
            grid = img.comps[mask.bit_length() - 1]
            mode, aux = proc.masking_aux(img, mask, grid)
            blocks, _orig = proc.masking_inputs(jpg, img, mask)
            out[mode] = (blocks, aux, mask)
    return out


@pytest.mark.parametrize("mode", ["444", "420y", "420c"])
def test_host_built_kernels_equal_plain(host_libs, states, mode):
    blocks, aux, mask = states[mode]
    early = mode == "444"
    args, _perm, _inv, _lim = zeroing.loop_inputs(
        blocks, blocks, np.float32(2.0), aux, mask, CPU, mode)
    coeffs_t, order_t, nrem, lim, lanes = args
    n = coeffs_t.shape[1]
    tab = tables.build(CPU)
    # The compare (A, A', A''): every block as it stands.
    ct = coeffs_t.reshape(3, 8, 8, n).contiguous()
    out = torch.empty(n)
    rc = _entry(host_libs, ka.ENTRY[mode])(
        ct.data_ptr(), *[a.data_ptr() for a in lanes], tab.data_ptr(),
        out.data_ptr(), n, None)
    assert rc == 0
    assert torch.equal(out, tl.COMPARE[mode](ct, *lanes))
    # The greedy loop (B, B', B''), with early exit in mode 444.
    out_idx = torch.empty((192, n), dtype=torch.int32)
    out_err = torch.empty((192, n))
    rc = _entry(host_libs, zl.ENTRY[mode])(
        coeffs_t.data_ptr(), order_t.data_ptr(), nrem.data_ptr(),
        lim.data_ptr(), *[a.data_ptr() for a in lanes], tab.data_ptr(),
        out_idx.data_ptr(), out_err.data_ptr(), n, 3, int(early), None)
    assert rc == 0
    want_idx, want_err = zl.zeroing_loop_plain(coeffs_t, order_t, nrem, lim,
                                               lanes, mode, early_exit=early)
    assert torch.equal(out_idx, want_idx)
    assert torch.equal(out_err, want_err)
    assert int(torch.isfinite(out_err).sum()) > n
    zeroing.check_final_errors(coeffs_t, out_idx, out_err, lanes, mode)


def test_host_built_tile_compare_equals_plain(host_libs, states):
    """Kernel C (blocks-leading, selection matrices) on every block of
    bees_d.jpg's 4:4:4 pass and on each block's first-step candidates:
    equal to its plain version, and to the plain compare A, bit for bit."""
    blocks, aux, _mask = states["444"]
    x0, sc, ysel, xsel = aux
    sy, sx = kc.selection_matrices(ysel, xsel)
    cand = torch.as_tensor(blocks)
    # The first greedy step zeroes the last nonzero AC coefficient.
    first = cand.clone().reshape(-1, 192)
    nz = (first != 0) & (torch.arange(192) % 64 != 0)
    last = 191 - nz.flip(1).int().argmax(1)
    first[torch.arange(len(first)), last] = 0
    cand = torch.cat([cand, first.reshape(-1, 3, 64)])
    rep = torch.cat([torch.arange(len(blocks))] * 2)
    args = (cand, x0[rep].contiguous(), sc[rep].contiguous(),
            sy[rep].contiguous(), sx[rep].contiguous())
    n = len(cand)
    tab = tables.build(CPU)
    out = torch.empty(n)
    rc = _entry(host_libs, kc.ENTRY)(
        *[a.data_ptr() for a in args], tab.data_ptr(), out.data_ptr(), n,
        None)
    assert rc == 0
    assert torch.equal(out, kc.tile_compare_plain(*args))
    lanes = tl.transpose_aux_444(x0[rep], sc[rep], ysel[rep], xsel[rep])
    assert torch.equal(out, tl.compare_blocks_lanes444(cand, *lanes))
    assert bool(torch.isfinite(out).all()) and float(out.max()) > 0
