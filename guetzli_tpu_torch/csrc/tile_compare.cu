// Kernel C: the per-block compare over blocks-leading candidates, with the
// image-edge replication as per-block 0/1 selection contractions.
//
// Replaces the TPU kernel guetzli_tpu/kernels/tile_compare.py
// (_tile_compare_pallas, body _kernel): one 4:4:4 CompareBlock per 8x8
// block. Its users are --checkcuda (checkcl.py) and the opt-in zeroing
// mode "444p" (GUETZLI_TPU_PALLAS=1), which evaluates every greedy step's
// candidates with it.
//
// Layout. Blocks leading, as the JAX kernel takes them: cand int32
// [N,3,64] (channel, u*8 + x), xyb0 float32 [N,3,64], scales float32
// [N,3], sy/sx int32 [N,8,8]; out float32 [N]. One thread per block:
// thread b reads cand[b*192 + k], xyb0[b*192 + k], scales[b*3 + c] and
// sy/sx[b*64 + ...], so a warp's reads of one element lie 768 bytes (256
// for sy/sx) apart -- the cost of the layout C takes. A later version may
// stage a CTA's blocks through shared memory with coalesced loads first.
//
// Steps. The integer IDCT, the fixed-point YCbCr->RGB transform and the
// float stage (finish_block) are compare_block.cuh's, shared with kernel
// A. Between the IDCT and the color transform, C replicates the edge as the
// JAX kernel does (tile_compare.py:341-365): v2[i][x] = sum_j sy[i][j] *
// v[j][x], then out[y][i] = sum_j sx[i][j] * v2[y][j], in int32, reading
// sy/sx from global memory where they are used (a private copy would add
// to a stack that already spills). For one-hot selection rows this is the
// clamp gather of kernel A exactly, so C equals A bit for bit; its plain
// PyTorch version is kernels/tile_compare.tile_compare_plain.
//
// Bound. About 10^5 float operations per block (finish_block) plus 5,760
// integer operations for the selection contractions, on 2,064 bytes of
// operands: arithmetic bounds it, as it does A.
//
// Built with --fmad=false (see compare_block.cuh): each multiply and add
// rounds on its own, as in the plain PyTorch version.

#include "compare_block.cuh"

// The selection contractions of one channel, in place on v[y*8 + x]:
// rows by sel_y, then columns by sel_x (each [i*8 + j], global memory).
__device__ __forceinline__ void select_rows_cols(
    int* v, const int* __restrict__ sel_y, const int* __restrict__ sel_x) {
  int t[64];
  for (int i = 0; i < 8; ++i)
    for (int x = 0; x < 8; ++x) {
      int acc = sel_y[i * 8] * v[x];
      for (int j = 1; j < 8; ++j) acc += sel_y[i * 8 + j] * v[j * 8 + x];
      t[i * 8 + x] = acc;
    }
  for (int y = 0; y < 8; ++y)
    for (int i = 0; i < 8; ++i) {
      int acc = sel_x[i * 8] * t[y * 8];
      for (int j = 1; j < 8; ++j) acc += sel_x[i * 8 + j] * t[y * 8 + j];
      v[y * 8 + i] = acc;
    }
}

extern "C" __global__ void __launch_bounds__(128)
tile_compare_kernel(const int* __restrict__ cand,
                    const float* __restrict__ xyb0,
                    const float* __restrict__ scales,
                    const int* __restrict__ sy, const int* __restrict__ sx,
                    const float* __restrict__ tables,
                    float* __restrict__ out, int n) {
  __shared__ float T[N_TABLES];
  gtk::load_tables(tables, T);
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const int* c = cand + (long)b * 192;
  const int* sel_y = sy + (long)b * 64;
  const int* sel_x = sx + (long)b * 64;
  float lin[192];
  {
    int v[192];
    for (int ch = 0; ch < 3; ++ch) {
      gtk::idct_block(c + ch * 64, v + ch * 64, T);
      select_rows_cols(v + ch * 64, sel_y, sel_x);
    }
    for (int p = 0; p < 64; ++p)
      gtk::store_linear(lin, p,
                        gtk::ycc_to_linear(v[p], v[64 + p], v[128 + p], T));
  }
  const float* s = scales + (long)b * 3;
  out[b] = gtk::finish_block(lin, xyb0 + (long)b * 192, 1, s[0], s[1], s[2],
                             T);
}

static int grid(int n, int threads) { return (n + threads - 1) / threads; }

extern "C" int gt_tile_compare(const void* cand, const void* xyb0,
                               const void* scales, const void* sy,
                               const void* sx, const void* tables, void* out,
                               int n, void* stream) {
  if (n <= 0) return 0;
  tile_compare_kernel<<<grid(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const int*)cand, (const float*)xyb0, (const float*)scales,
      (const int*)sy, (const int*)sx, (const float*)tables, (float*)out, n);
  return (int)cudaGetLastError();
}
