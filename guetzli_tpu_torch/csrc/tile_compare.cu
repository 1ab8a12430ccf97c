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
// [N,3], sy/sx int32 [N,8,8]; out float32 [N].
//
// Design. A team compare, as A is (tile_compare_lanes.cu): one CTA of 64
// threads per block loads the block into the shared-memory Layout of mode
// Team444Sel and runs one evaluation of compare_team.cuh on it. Block b's
// operands each lie in one contiguous run (b*192 + k, b*3 + c, b*64 + k),
// so the CTA's threads read consecutive words, with no staging; the
// element order is the lane-major layout's (c*64 + y*8 + x), so the
// Layout offsets are those of load_state. The pixel stage replicates the
// edge as the JAX kernel does (tile_compare.py:341-365): rows by sy, then
// columns by sx, int32 sums read from shared memory, one output per
// thread; its clamp row is ymax = xmax = 7, valid = 1. The float stage is
// A's, so for one-hot selection rows C equals A bit for bit; its plain
// PyTorch version is kernels/tile_compare.tile_compare_plain.
//
// Bound. About 5*10^4 float operations per block plus 5,760 integer
// operations for the selection contractions, on 2,064 bytes of operands:
// arithmetic bounds it, as it does A. 16 CTAs of 64 threads per SM, at
// most 64 registers a thread, hide each other's 13 barriers.
//
// Built with --fmad=false (see compare_block.cuh): each multiply and add
// rounds on its own, as in the plain PyTorch version.

#include "compare_block.cuh"
#include "compare_team.cuh"

extern __shared__ float4 team_smem[];

using LSel = gtt::Layout<gtt::Team444Sel>;
static_assert(LSel::THREADS == 64, "one thread per selection row entry");

// The error of block blockIdx.x by the whole CTA (grid: exactly the n
// blocks). Every thread reaches every barrier.
extern "C" __global__ void __launch_bounds__(LSel::THREADS,
                                             gtt::Team444Sel::MINB)
tile_compare_kernel(const int* __restrict__ cand,
                    const float* __restrict__ xyb0,
                    const float* __restrict__ scales,
                    const int* __restrict__ sy, const int* __restrict__ sx,
                    const float* __restrict__ tables,
                    float* __restrict__ out) {
  float* sf = (float*)team_smem;
  int* si = (int*)(sf + LSel::NF);
  const int tid = threadIdx.x;
  const long b = blockIdx.x;
  // The closed forms only, as the JAX kernel (LSel::NT = N_CLOSED).
  for (int i = tid; i < LSel::NT; i += LSel::THREADS)
    sf[LSel::TAB + i] = tables[i];
  for (int i = tid; i < 192; i += LSel::THREADS) {
    si[LSel::C + i] = cand[b * 192 + i];
    sf[LSel::X0 + i] = xyb0[b * 192 + i];
  }
  if (tid < 3) sf[LSel::SC + tid] = scales[b * 3 + tid];
  si[LSel::NBI + tid] = sy[b * 64 + tid];
  si[LSel::NBI + 64 + tid] = sx[b * 64 + tid];
  if (tid < 3) si[LSel::CL + tid] = tid < 2 ? 7 : 1;  // ymax, xmax, valid
  __syncthreads();
  gtt::Rows R;
  gtt::load_rows(sf + LSel::TAB, tid & 7, R);
  const float e = gtt::eval_team<gtt::Team444Sel>(si + LSel::C, -1, sf, si,
                                                  R, tid);
  if (tid == 0) out[b] = e;
}

extern "C" int gt_tile_compare(const void* cand, const void* xyb0,
                               const void* scales, const void* sy,
                               const void* sx, const void* tables, void* out,
                               int n, void* stream) {
  if (n <= 0) return 0;
  int rc = gtt::prefer_smem(tile_compare_kernel);
  if (rc != 0) return rc;
  tile_compare_kernel<<<n, LSel::THREADS, LSel::BYTES,
                        (cudaStream_t)stream>>>(
      (const int*)cand, (const float*)xyb0, (const float*)scales,
      (const int*)sy, (const int*)sx, (const float*)tables, (float*)out);
  return (int)cudaGetLastError();
}

// The launch geometry of kernel C (mode 0, its only one): threads and
// dynamic shared memory bytes per CTA, and the CTAs that fit on one SM.
extern "C" int gt_tile_compare_geometry(int mode, int* threads,
                                        int* smem_bytes, int* ctas_per_sm) {
  if (mode != 0) return 1;  // cudaErrorInvalidValue
  return gtt::geometry<gtt::Team444Sel>(tile_compare_kernel, threads,
                                        smem_bytes, ctas_per_sm);
}
