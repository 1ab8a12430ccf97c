// Kernels A, A' and A'': the per-block compare over lane-major candidates.
//
// A replaces the TPU kernel guetzli_tpu/kernels/tile_compare_lanes.py
// (_tile_compare_lanes, body _kernel): one 4:4:4 CompareBlock per 8x8
// block. A' and A'' are the 4:2:0 compares that the JAX package computes
// in XLA (guetzli_tpu/ops/tiles_lanes.py: compare_blocks_lanes420y, the Y
// pass against frozen chroma; compare_blocks_lanes420c, one 16x16
// macroblock's chroma against frozen Y). They exist so that the zeroing
// driver can re-evaluate the greedy kernels B' and B'' with the function
// they compute, as it does B with A.
//
// Layout. Inputs are lane-major, block index minor: cand int32 [3,8,8,N]
// (A' reads plane 0, A'' planes 1 and 2), then the mode's frozen state:
// A: x0 float32 [3,8,8,N], sc float32 [3,N], ymax/xmax int32 [N];
// A': chroma int32 [2,8,8,N] and A's state; A'': nu/nv int32 [10,10,N],
// y16 int32 [16,16,N], x0c float32 [2,2,3,8,8,N], scc float32 [2,2,3,N],
// ymaxc/xmaxc/validc int32 [2,2,N]. out float32 [N].
//
// Two designs. A and A' run one thread per block, 128 threads per CTA,
// so neighbouring threads read neighbouring addresses of every operand;
// the whole chain of one block runs in one thread (compare_block.cuh)
// with its state in local memory. A'' is a team compare: one CTA of four
// 64-thread units (one per 8x8 sub-block) per macroblock loads the lane's
// Cb/Cr candidates and frozen state into shared memory and runs one
// evaluation of compare_team.cuh, the same load and evaluation as the
// greedy kernel B'' (zeroing_loop.cu), so the two agree by construction.
//
// Bound. About 10^5 float operations per 8x8 evaluation (four of them
// for A'') for about 1.2 KB (A'': 5.6 KB) of operand bytes: arithmetic
// bounds it, not memory.
//
// Built with --fmad=false (see compare_block.cuh): each multiply and add
// rounds on its own, as in the plain PyTorch version.

#include "compare_block.cuh"
#include "compare_team.cuh"

extern __shared__ float4 team_smem[];

extern "C" __global__ void __launch_bounds__(128)
tile_compare_lanes_kernel(const int* __restrict__ cand,
                          const float* __restrict__ x0,
                          const float* __restrict__ sc,
                          const int* __restrict__ ymax,
                          const int* __restrict__ xmax,
                          const float* __restrict__ tables,
                          float* __restrict__ out, int n) {
  __shared__ float T[N_TABLES];
  gtk::load_tables(tables, T);
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  int c[192];
  for (int k = 0; k < 192; ++k) c[k] = cand[(long)k * n + b];
  out[b] = gtk::compare_block(c, x0 + b, n, sc[b], sc[n + b], sc[2L * n + b],
                              ymax[b], xmax[b], T);
}

extern "C" __global__ void __launch_bounds__(128)
tile_compare_lanes_420y_kernel(const int* __restrict__ cand,
                               const int* __restrict__ chroma,
                               const float* __restrict__ x0,
                               const float* __restrict__ sc,
                               const int* __restrict__ ymax,
                               const int* __restrict__ xmax,
                               const float* __restrict__ tables,
                               float* __restrict__ out, int n) {
  __shared__ float T[N_TABLES];
  gtk::load_tables(tables, T);
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  int c[64];
  for (int k = 0; k < 64; ++k) c[k] = cand[(long)k * n + b];
  out[b] = gtk::compare_block_420y(c, chroma + b, x0 + b, n, sc[b],
                                   sc[n + b], sc[2L * n + b], ymax[b],
                                   xmax[b], T);
}

using L420c = gtt::Layout<gtt::Team420c>;

extern "C" __global__ void __launch_bounds__(L420c::THREADS,
                                             gtt::Team420c::MINB)
tile_compare_lanes_420c_kernel(
    const int* __restrict__ cand, const int* __restrict__ nu,
    const int* __restrict__ nv, const int* __restrict__ y16,
    const float* __restrict__ x0c, const float* __restrict__ scc,
    const int* __restrict__ ymaxc, const int* __restrict__ xmaxc,
    const int* __restrict__ validc, const float* __restrict__ tables,
    float* __restrict__ out, int n) {
  float* sf = (float*)team_smem;
  int* si = (int*)(sf + L420c::NF);
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int i = 64 + tid; i < 192; i += L420c::THREADS)
    si[L420c::C + i] = cand[(long)i * n + b];
  const gtt::State s{x0c, scc, ymaxc, xmaxc, validc, {nu, nv, y16}};
  gtt::load_state<gtt::Team420c>(s, tables, sf, si, b, n, tid);
  __syncthreads();
  gtt::Rows R;
  gtt::load_rows(sf + L420c::TAB, tid & 7, R);
  const float e =
      gtt::eval_team<gtt::Team420c>(si + L420c::C, -1, sf, si, R, tid);
  if (tid == 0) out[b] = e;
}

static int grid(int n, int threads) { return (n + threads - 1) / threads; }

extern "C" int gt_tile_compare_lanes(const void* cand, const void* x0,
                                     const void* sc, const void* ymax,
                                     const void* xmax, const void* tables,
                                     void* out, int n, void* stream) {
  if (n <= 0) return 0;
  tile_compare_lanes_kernel<<<grid(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const int*)cand, (const float*)x0, (const float*)sc, (const int*)ymax,
      (const int*)xmax, (const float*)tables, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int gt_tile_compare_lanes_420y(const void* cand,
                                          const void* chroma, const void* x0,
                                          const void* sc, const void* ymax,
                                          const void* xmax,
                                          const void* tables, void* out,
                                          int n, void* stream) {
  if (n <= 0) return 0;
  tile_compare_lanes_420y_kernel<<<grid(n, 128), 128, 0,
                                   (cudaStream_t)stream>>>(
      (const int*)cand, (const int*)chroma, (const float*)x0,
      (const float*)sc, (const int*)ymax, (const int*)xmax,
      (const float*)tables, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int gt_tile_compare_lanes_420c(
    const void* cand, const void* nu, const void* nv, const void* y16,
    const void* x0c, const void* scc, const void* ymaxc, const void* xmaxc,
    const void* validc, const void* tables, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  int rc = gtt::prefer_smem(tile_compare_lanes_420c_kernel);
  if (rc != 0) return rc;
  tile_compare_lanes_420c_kernel<<<n, L420c::THREADS, L420c::BYTES,
                                   (cudaStream_t)stream>>>(
      (const int*)cand, (const int*)nu, (const int*)nv, (const int*)y16,
      (const float*)x0c, (const float*)scc, (const int*)ymaxc,
      (const int*)xmaxc, (const int*)validc, (const float*)tables,
      (float*)out, n);
  return (int)cudaGetLastError();
}

// The launch geometry of team compare `mode` (0: A''): threads and dynamic
// shared memory bytes per CTA, and the CTAs that fit on one SM.
extern "C" int gt_tile_compare_lanes_geometry(int mode, int* threads,
                                              int* smem_bytes,
                                              int* ctas_per_sm) {
  if (mode != 0) return 1;  // cudaErrorInvalidValue
  return gtt::geometry<gtt::Team420c>(tile_compare_lanes_420c_kernel,
                                      threads, smem_bytes, ctas_per_sm);
}
