// verify_argmax: the verifier's greedy tokens, (argmax, max) over V of h @ w.
//
// Replaces the Pallas kernel src/repro/kernels/verify_argmax.py
// (verify_argmax, pallas_call at :62), which folds a running (max, argmax)
// across vocab tiles in a sequential grid axis.  Hopper blocks run in no
// order, so the fold is split in two: pass 1 has each block write one
// (max, arg) per row for its 64 vocab columns; pass 2 reduces those
// partials per row.  The (T, V) logits never reach device memory.
//
// Tie rule: the lowest index wins among equal maxima, as jnp.argmax and the
// Pallas kernel's strict ">" give.  Both passes combine (value, index) pairs
// with "greater value, or equal value and lower index", which is
// associative, so the result does not depend on the reduction order; and
// vocab_tile.cuh sums every column in the same order, so equal columns of w
// give bit-equal logits.
//
// Bound on H100: one read of w, d*V elements (262 MB at vicuna-7b in bf16,
// about 78 us at 3.35 TB/s); T*d*V FMAs are below the tensor-core rate but
// above the float32 CUDA-core rate at T = 40, so this first version, on the
// CUDA cores, is bound by its float32 FMAs rather than by the bytes.
#include <climits>

#include "vocab_tile.cuh"

namespace {

__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    better(v, i, v2, i2);
  }
}

// Pass 1: block j writes the best (max, arg) of every row over its columns.
template <typename TI, int RT>
__global__ void __launch_bounds__(vocab::THREADS)
verify_partial(const TI* __restrict__ h, const TI* __restrict__ w, int T, int d, int V,
               float* __restrict__ part_max, int* __restrict__ part_arg, int nblk) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* red = smem + vocab::DC * RT;
  const int c0 = blockIdx.x * vocab::COLS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < T; r0 += RT) {
    vocab::tile<TI, RT>(h, w, T, d, V, r0, c0, hs, red);
    for (int r = warp; r < RT && r0 + r < T; r += vocab::NWARP) {
      const int c = c0 + 2 * lane;
      float v = c < V ? red[r * vocab::COLS + 2 * lane] : -INFINITY;
      int i = c;
      better(v, i, c + 1 < V ? red[r * vocab::COLS + 2 * lane + 1] : -INFINITY, c + 1);
      warp_best(v, i);
      if (lane == 0) {
        part_max[(size_t)(r0 + r) * nblk + blockIdx.x] = v;
        part_arg[(size_t)(r0 + r) * nblk + blockIdx.x] = i;
      }
    }
    __syncthreads();
  }
}

// Pass 2: one block per row reduces the row's nblk partials.
__global__ void __launch_bounds__(256)
verify_reduce(const float* __restrict__ part_max, const int* __restrict__ part_arg, int nblk,
              int* __restrict__ out_arg, float* __restrict__ out_max) {
  __shared__ float sv[8];
  __shared__ int si[8];
  const int row = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = -INFINITY;
  int i = INT_MAX;
  for (int j = threadIdx.x; j < nblk; j += blockDim.x)
    better(v, i, part_max[(size_t)row * nblk + j], part_arg[(size_t)row * nblk + j]);
  warp_best(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < 8 ? sv[lane] : -INFINITY;
    i = lane < 8 ? si[lane] : INT_MAX;
    warp_best(v, i);
    if (lane == 0) {
      out_arg[row] = i;
      out_max[row] = v;
    }
  }
}

template <typename TI, int RT>
cudaError_t launch_partial(const TI* h, const TI* w, int T, int d, int V, float* pm,
                           int* pa, int nblk, cudaStream_t s) {
  const size_t smem = vocab::tile_smem_floats(RT) * sizeof(float);
  cudaError_t e = allow_smem(verify_partial<TI, RT>, smem);
  if (e != cudaSuccess) return e;
  verify_partial<TI, RT><<<nblk, vocab::THREADS, smem, s>>>(h, w, T, d, V, pm, pa, nblk);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t run(const void* h, const void* w, int T, int d, int V, float* pm, int* pa,
                int nblk, int* oa, float* om, cudaStream_t s) {
  const TI* hp = static_cast<const TI*>(h);
  const TI* wp = static_cast<const TI*>(w);
  cudaError_t e;
  switch (vocab::rows_per_pass(T)) {
    case 8:  e = launch_partial<TI, 8>(hp, wp, T, d, V, pm, pa, nblk, s); break;
    case 16: e = launch_partial<TI, 16>(hp, wp, T, d, V, pm, pa, nblk, s); break;
    case 24: e = launch_partial<TI, 24>(hp, wp, T, d, V, pm, pa, nblk, s); break;
    case 32: e = launch_partial<TI, 32>(hp, wp, T, d, V, pm, pa, nblk, s); break;
    case 40: e = launch_partial<TI, 40>(hp, wp, T, d, V, pm, pa, nblk, s); break;
    default: e = launch_partial<TI, 48>(hp, wp, T, d, V, pm, pa, nblk, s); break;
  }
  if (e != cudaSuccess) return e;
  verify_reduce<<<T, 256, 0, s>>>(pm, pa, nblk, oa, om);
  return cudaGetLastError();
}

}  // namespace

DVI_EXPORT int dvi_verify_argmax(const void* h, const void* w, int T, int d, int V,
                                 int is_bf16, void* part_max, void* part_arg, int nblk,
                                 void* out_arg, void* out_max, void* stream) {
  if (T <= 0 || d <= 0 || V <= 0 || nblk != (V + vocab::COLS - 1) / vocab::COLS)
    return cudaErrorInvalidValue;
  float* pm = static_cast<float*>(part_max);
  int* pa = static_cast<int*>(part_arg);
  int* oa = static_cast<int*>(out_arg);
  float* om = static_cast<float*>(out_max);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(h, w, T, d, V, pm, pa, nblk, oa, om, s)
                 : run<float>(h, w, T, d, V, pm, pa, nblk, oa, om, s);
}
