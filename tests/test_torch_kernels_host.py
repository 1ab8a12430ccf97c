"""The CUDA kernels' source, compiled for the host, against their plain
PyTorch versions on the CPU.

The kernels of guetzli_tpu_torch/csrc run only on the card (chip_smoke.py
and the gpu-marked test hold them there). Their logic -- the operand
layouts, the three modes' pixel stages, the greedy loop -- is plain C++
apart from a few CUDA keywords, so this test compiles the same sources
with g++ behind a small shim and calls the same C entry points on CPU
tensors. The shim defines the keywords away and rewrites each launch
``k<<<grid, threads, smem, ...>>>(args)`` as a call that runs the grid's
CTAs one after another, each CTA's threads as fibers that run
concurrently between barriers: ``__syncthreads()`` returns once every
thread of the CTA has reached it, and a barrier that some threads skip
fails the launch. The team kernels B, B', B'', A, A', A'' and C (one
CTA per block or macroblock, their state in shared memory) rely on that.

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
from tests.torch_selection import KINDS, selection_matrices
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

_SHIM = r"""#pragma once
// The CUDA keywords the kernels use, for g++. A launch runs the grid's
// CTAs one after another; a CTA's threads run as fibers (ucontext), each
// until its next __syncthreads(), which returns once every thread of the
// CTA has reached the same barrier. A barrier that some threads skip or
// reach at another line fails the launch (cudaGetLastError() != 0).
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>
#include <ucontext.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
struct dim3v { unsigned x, y, z; };
static dim3v threadIdx, blockIdx, blockDim;
typedef struct CUstream_st* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9,
  cudaSharedmemCarveoutMaxShared = 100
};
struct float3 { float x, y, z; };
struct float4 { float x, y, z, w; };
inline float3 make_float3(float x, float y, float z) {
  return float3{x, y, z};
}
static unsigned char* gt_dynamic_smem;
static int gt_launch_error;
inline int cudaGetLastError() {
  int e = gt_launch_error;
  gt_launch_error = 0;
  return e;
}
template <class K>
inline int cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                         size_t) {
  *n = 1;
  return 0;
}
namespace gt_shim {
struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  int state;  // 0 runnable, 1 at a barrier, 2 finished
  int line;   // the barrier's source line
};
static ucontext_t sched;
static Fiber* cur;
static const std::function<void()>* body;
static void entry() {
  (*body)();
  cur->state = 2;
  swapcontext(&cur->ctx, &sched);
}
inline void sync(int line) {
  cur->state = 1;
  cur->line = line;
  swapcontext(&cur->ctx, &sched);
}
inline void launch(unsigned grid, unsigned threads, size_t smem,
                   const std::function<void()>& fn) {
  body = &fn;
  std::vector<Fiber> fib(threads);
  for (auto& f : fib) f.stack.resize(1 << 15);
  std::vector<unsigned char> dyn(smem + 16);
  gt_dynamic_smem = dyn.data() + (16 - (size_t)dyn.data() % 16) % 16;
  blockDim.x = threads;
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::memset(gt_dynamic_smem, 0xff, smem);  // NaN floats, -1 ints
    for (auto& f : fib) {
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = f.stack.size();
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, entry, 0);
      f.state = 0;
    }
    // Each round runs every thread to its next barrier, in alternating
    // order, so that a missing barrier shows as a wrong result.
    for (unsigned round = 0;; ++round) {
      for (unsigned i = 0; i < threads; ++i) {
        unsigned t = (round & 1) ? threads - 1 - i : i;
        if (fib[t].state == 2) continue;
        cur = &fib[t];
        threadIdx.x = t;
        fib[t].state = 0;
        swapcontext(&sched, &fib[t].ctx);
      }
      unsigned done = 0, same = 0;
      for (auto& f : fib) {
        done += f.state == 2;
        same += f.state == 1 && f.line == fib[0].line;
      }
      if (done == threads) break;
      if (same != threads) {
        gt_launch_error = 999;
        return;
      }
    }
  }
}
}  // namespace gt_shim
#define __syncthreads() gt_shim::sync(__LINE__)
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
    """Each ``k<<<grid, threads[, smem, stream]>>>(args);`` becomes
    ``gt_shim::launch(grid, threads, smem, [&] { k(args); });`` and each
    ``extern __shared__ T name[];`` a name for the launch's buffer."""
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"#define \2 ((\1*)gt_dynamic_smem)", text)
    out, pos, n = [], 0, 0
    for m in re.finditer(r"(\w+)<<<(.*?)>>>\(", text, flags=re.S):
        if m.start() < pos:
            continue
        depth, i = 1, m.end()
        while depth:
            depth += (text[i] == "(") - (text[i] == ")")
            i += 1
        assert text[i] == ";"
        cfg = _split_top(m.group(2)) + ["0"]
        out.append(text[pos:m.start()])
        out.append("gt_shim::launch(%s, %s, %s, [&] { %s(%s); });"
                   % (cfg[0], cfg[1], cfg[2], m.group(1),
                      text[m.end():i - 1]))
        pos = i + 1
        n += 1
    assert n >= 1
    return "".join(out) + text[pos:]


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
        out.data_ptr(), n, 0, None)
    assert rc == 0
    assert torch.equal(out, tl.COMPARE[mode](ct, *lanes))
    # The greedy loop (B, B', B''), with early exit in mode 444.
    out_idx = torch.empty((192, n), dtype=torch.int32)
    out_err = torch.empty((192, n))
    rc = _entry(host_libs, zl.ENTRY[mode])(
        coeffs_t.data_ptr(), order_t.data_ptr(), nrem.data_ptr(),
        lim.data_ptr(), *[a.data_ptr() for a in lanes], tab.data_ptr(),
        out_idx.data_ptr(), out_err.data_ptr(), n, 3, int(early), 0, None)
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


@pytest.mark.parametrize("kind", KINDS)
def test_host_built_tile_compare_general_selection(host_libs, states, kind):
    """Kernel C on every block of bees_d.jpg's 4:4:4 pass with 0/1
    selection matrices that no edge clamp gives (all-zero rows, rows with
    two ones, permutations; tests/torch_selection.py): equal to its plain
    version bit for bit, as the JAX kernel contracts any int32 matrix."""
    blocks, aux, _mask = states["444"]
    x0, sc, _ysel, _xsel = aux
    n = len(blocks)
    sy, sx = (torch.as_tensor(m) for m in selection_matrices(n, kind, 7))
    args = (torch.as_tensor(blocks), x0.contiguous(), sc.contiguous(), sy,
            sx)
    tab = tables.build(CPU)
    out = torch.empty(n)
    rc = _entry(host_libs, kc.ENTRY)(
        *[a.data_ptr() for a in args], tab.data_ptr(), out.data_ptr(), n,
        None)
    assert rc == 0
    assert torch.equal(out, kc.tile_compare_plain(*args))
    assert bool(torch.isfinite(out).all())
    # The rows change the pixels: C is not A on these blocks.
    lanes = tl.transpose_aux_444(x0, sc, *aux[2:])
    assert not torch.equal(out, tl.compare_blocks_lanes444(args[0], *lanes))


_TEAM_CASES = [(m, la, e) for m in ("444", "420y", "420c")
               for la in (1, 2, 3, 4) for e in (False, True)]
# Per mode: the error limit, and for the 8x8 modes the longest loops kept
# in the subset of blocks (an odd count of blocks in all).
_TEAM_LIMIT = {"444": 4.0, "420y": 3.0, "420c": 3.0}
_TEAM_LONGEST = {"444": 5, "420y": 4}


@pytest.mark.parametrize(
    "mode,lookahead,early", _TEAM_CASES,
    ids=["%s-%d-%s" % (m, la, "early" if e else "full")
         for m, la, e in _TEAM_CASES])
def test_host_built_team_kernels_equal_plain(host_libs, states, mode,
                                             lookahead, early):
    """The team kernels B, B' and B'' (one CTA per block, its state in
    shared memory) against the plain loop, rails bit for bit, at each
    lookahead up to one past the default 3, with and without early exit.
    Modes 444 and 420y run an odd subset of bees_d's and bees_d-420's
    blocks: the longest loops, every fourth of the rest and blocks with 1
    and 0 candidates; mode 420c all 28 macroblocks of bees_d-420, whose
    last column has invalid sub-blocks."""
    blocks, aux, mask = states[mode]
    limit = np.float32(_TEAM_LIMIT[mode])
    if mode in _TEAM_LONGEST:
        args, perm, _inv, _lim = zeroing.loop_inputs(
            blocks, blocks, limit, aux, mask, CPU, mode)
        nrem = args[2].numpy()
        pos = np.unique(np.concatenate([
            np.arange(_TEAM_LONGEST[mode]),
            np.arange(_TEAM_LONGEST[mode], len(nrem), 4),
            np.flatnonzero(nrem == 1)[:2], np.flatnonzero(nrem == 0)[:2]]))
        sel = perm[pos]
        blocks = blocks[sel]
        aux = [a[torch.as_tensor(sel)] for a in aux]
    args, _perm, _inv, _lim = zeroing.loop_inputs(
        blocks, blocks, limit, aux, mask, CPU, mode)
    coeffs_t, order_t, nrem, lim, lanes = args
    n = coeffs_t.shape[1]
    assert n % 2 == 1 or mode == "420c"
    assert {0, 1} <= set(nrem.tolist())
    if mode == "420c":
        assert int(lanes[-1].reshape(4, n).sum(0).min()) < 4
    tab = tables.build(CPU)
    out_idx = torch.empty((192, n), dtype=torch.int32)
    out_err = torch.empty((192, n))
    rc = _entry(host_libs, zl.ENTRY[mode])(
        coeffs_t.data_ptr(), order_t.data_ptr(), nrem.data_ptr(),
        lim.data_ptr(), *[a.data_ptr() for a in lanes], tab.data_ptr(),
        out_idx.data_ptr(), out_err.data_ptr(), n, lookahead, int(early),
        0, None)
    assert rc == 0
    want_idx, want_err = zl.zeroing_loop_plain(
        coeffs_t, order_t, nrem, lim, lanes, mode, lookahead=lookahead,
        early_exit=early)
    assert torch.equal(out_idx, want_idx)
    assert torch.equal(out_err, want_err)
    steps = torch.isfinite(out_err).sum(0)
    if early:
        assert bool((steps < nrem).any())   # some block stopped early
    else:
        assert torch.equal(steps, nrem.clamp(max=192).to(steps.dtype))
    zeroing.check_final_errors(coeffs_t, out_idx, out_err, lanes, mode)


@pytest.mark.parametrize("mode", ["444", "420y", "420c"])
def test_host_built_team_compare(host_libs, states, mode):
    """The team compares A, A' and A'' on every block of bees_d's 4:4:4
    pass, of bees_d-420's Y pass, or all 28 macroblocks of its chroma pass
    (the last column has invalid sub-blocks), and on each one's first-step
    candidates (its three best-scored coefficients zeroed in turn): equal
    to the plain version bit for bit, and to the final errors of the
    host-built greedy kernel B, B' or B'' on the blocks' finished loops."""
    blocks, aux, mask = states[mode]
    early = mode == "444"
    args, _perm, _inv, _lim = zeroing.loop_inputs(
        blocks, blocks, np.float32(_TEAM_LIMIT[mode]), aux, mask, CPU, mode)
    coeffs_t, order_t, nrem, lim, lanes = args
    n = coeffs_t.shape[1]
    assert n == {"444": 104, "420y": 104, "420c": 28}[mode]
    if mode == "420c":
        assert int(lanes[-1].reshape(4, n).sum(0).min()) < 4
    tab = tables.build(CPU)
    compare = _entry(host_libs, ka.ENTRY[mode])

    def host_a(cand, lanes_m):
        m = cand.shape[-1]
        out = torch.empty(m)
        rc = compare(cand.contiguous().data_ptr(),
                     *[a.data_ptr() for a in lanes_m], tab.data_ptr(),
                     out.data_ptr(), m, 0, None)
        assert rc == 0
        return out

    # Every block as it stands, then its first step's candidates.
    rows = torch.arange(192)[:, None]
    firsts = [torch.where(rows == order_t[l][None, :], 0, coeffs_t)
              for l in range(3)]
    cand = torch.cat([coeffs_t] + firsts, 1).reshape(3, 8, 8, 4 * n)
    lanes4 = [torch.cat([a] * 4, -1).contiguous() for a in lanes]
    got = host_a(cand.contiguous(), lanes4)
    assert torch.equal(got, tl.COMPARE[mode](cand.contiguous(), *lanes4))
    assert bool(torch.isfinite(got).all()) and float(got.max()) > 0
    # The last error of the greedy kernel in each block equals the compare
    # on its final coefficients.
    out_idx = torch.empty((192, n), dtype=torch.int32)
    out_err = torch.empty((192, n))
    rc = _entry(host_libs, zl.ENTRY[mode])(
        coeffs_t.data_ptr(), order_t.data_ptr(), nrem.data_ptr(),
        lim.data_ptr(), *[a.data_ptr() for a in lanes], tab.data_ptr(),
        out_idx.data_ptr(), out_err.data_ptr(), n, 3, int(early), 0, None)
    assert rc == 0
    steps = torch.isfinite(out_err).sum(0)
    final = coeffs_t.clone()
    for b in range(n):
        final[out_idx[:steps[b], b].long(), b] = 0
    last = out_err.gather(0, (steps - 1).clamp(min=0)[None])[0]
    errs = host_a(final.reshape(3, 8, 8, n), lanes)
    done = steps > 0
    assert int(done.sum()) > n // 2
    assert torch.equal(errs[done], last[done])


def test_host_team_geometry(host_libs):
    """The geometry entry points of the team kernels: one unit of 64
    threads per 8x8 block (B, B', A, A' and C: one, B'' and A'': four), the
    dynamic shared memory of each CTA within the 48 KB a launch may take
    without asking. A, A' and A'' take the layouts of B, B' and B''; C
    takes A's and its two selection matrices, 512 B more."""
    got = []
    for entry, mode in (("zeroing_loop_geometry", 0),
                        ("zeroing_loop_geometry", 2),
                        ("zeroing_loop_geometry", 1),
                        ("tile_compare_lanes_geometry", 0),
                        ("tile_compare_lanes_geometry", 1),
                        ("tile_compare_lanes_geometry", 2),
                        ("tile_compare_geometry", 0)):
        fn = _entry(host_libs, entry)
        vals = [ctypes.c_int(-1) for _ in range(3)]
        assert fn(mode, *[ctypes.byref(v) for v in vals]) == 0
        got.append([v.value for v in vals])
    assert [g[0] for g in got] == [64, 64, 256, 256, 64, 64, 64]
    assert 0 < got[1][1] < got[0][1] < got[2][1] <= 48 * 1024
    assert got[3:6] == [got[2], got[0], got[1]]
    assert got[6][1] == got[4][1] + 512 <= 48 * 1024
    assert all(g[2] == 1 for g in got)
    bad = ctypes.c_int(0)
    for entry, mode in (("tile_compare_lanes_geometry", 3),
                        ("tile_compare_geometry", 1)):
        assert _entry(host_libs, entry)(
            mode, ctypes.byref(bad), ctypes.byref(bad),
            ctypes.byref(bad)) != 0


@pytest.mark.parametrize("mode", ["444", "420y", "420c"])
def test_host_built_exact_lut_variants(host_libs, states, mode):
    """The EXACT_LUT variants of A, A', A'' and B, B', B'' (the kernels'
    table forms, exact=1: the LF and HF DY reads by table) against the
    plain versions with exact_lut=True, bit for bit: the compare on every
    block and its first-step candidates, the greedy loop's two rails."""
    blocks, aux, mask = states[mode]
    args, _perm, _inv, _lim = zeroing.loop_inputs(
        blocks, blocks, np.float32(_TEAM_LIMIT[mode]), aux, mask, CPU, mode)
    coeffs_t, order_t, nrem, lim, lanes = args
    n = coeffs_t.shape[1]
    tab = tables.build(CPU)
    rows = torch.arange(192)[:, None]
    firsts = [torch.where(rows == order_t[l][None, :], 0, coeffs_t)
              for l in range(3)]
    cand = torch.cat([coeffs_t] + firsts, 1).reshape(3, 8, 8, 4 * n) \
        .contiguous()
    lanes4 = [torch.cat([a] * 4, -1).contiguous() for a in lanes]
    out = torch.empty(4 * n)
    rc = _entry(host_libs, ka.ENTRY[mode])(
        cand.data_ptr(), *[a.data_ptr() for a in lanes4], tab.data_ptr(),
        out.data_ptr(), 4 * n, 1, None)
    assert rc == 0
    assert torch.equal(out, tl.COMPARE[mode](cand, *lanes4, exact_lut=True))
    # The tables are another function than the closed forms.
    assert not torch.equal(out, tl.COMPARE[mode](cand, *lanes4,
                                                 exact_lut=False))
    out_idx = torch.empty((192, n), dtype=torch.int32)
    out_err = torch.empty((192, n))
    rc = _entry(host_libs, zl.ENTRY[mode])(
        coeffs_t.data_ptr(), order_t.data_ptr(), nrem.data_ptr(),
        lim.data_ptr(), *[a.data_ptr() for a in lanes], tab.data_ptr(),
        out_idx.data_ptr(), out_err.data_ptr(), n, 3, 0, 1, None)
    assert rc == 0
    want_idx, want_err = zl.zeroing_loop(coeffs_t, order_t, nrem, lim,
                                         lanes, mode, exact_lut=True)
    assert torch.equal(out_idx, want_idx)
    assert torch.equal(out_err, want_err)
    assert int(torch.isfinite(out_err).sum()) > n

