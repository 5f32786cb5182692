// verify_argmax: the verifier's greedy tokens, (argmax, max) over V of h @ w.
//
// Replaces the Pallas kernel src/repro/kernels/verify_argmax.py
// (verify_argmax, pallas_call at :62), which folds a running (max, argmax)
// across vocab tiles in a sequential grid axis.  Hopper blocks run in no
// order, so the fold is split in two: pass 1 streams w through
// vocab_tile.cuh and folds each (row, strip of 128 columns) from the
// accumulator fragments into one (max, arg) partial; pass 2 reduces a row's
// partials.  Pass 2 is a programmatic dependent launch, released as pass
// 1's CTAs finish, so its launch overlaps pass 1's end.  The (T, V) logits
// never reach device memory.
//
// Tie rule: the lowest index wins among equal maxima, as jnp.argmax and the
// Pallas kernel's strict ">" give.  Every fold combines (value, index) pairs
// with "greater value, or equal value and lower index", which is
// associative, so the result does not depend on the reduction order; and
// vocab_tile.cuh sums every column in the same order, so equal columns of w
// give bit-equal logits.
//
// Bound on H100: one read of w, d*V elements (262 MB at vicuna-7b in bf16,
// about 78 us at 3.35 TB/s).  At T = 40 the 10.5 GFLOP of the product take
// about 11 us on the tensor cores, so the bytes bound it; vocab_tile.cuh
// keeps 32 KB of w in flight a CTA, three CTAs an SM, to stream near that
// rate.
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

// The epilogue of a (row pass, strip): each row's best over the strip's
// columns, folded in registers, across the eight lanes that share the row,
// then across the warps in shared memory; one partial per row and strip.
template <int NT>
struct ArgmaxEpi {
  int T, V, nblk;
  float* part_max;
  int* part_arg;
  float* rv;    // (NWARP, RT) shared
  int* ri;

  __device__ __forceinline__ void mid(int, int) {}

  __device__ __forceinline__ void operator()(const float (&acc)[2][NT][4], int s, int r0) {
    constexpr int RT = 8 * NT;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int cb = s * vocab::COLS + warp * 32 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float v = -INFINITY;
        int i = INT_MAX;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int c = cb + mt * 16 + hi * 8;
            if (c < V) better(v, i, acc[mt][nt][hi * 2 + e2], c);
          }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
          const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
          better(v, i, v2, i2);
        }
        if (g == 0) {
          rv[warp * RT + nt * 8 + 2 * t + e2] = v;
          ri[warp * RT + nt * 8 + 2 * t + e2] = i;
        }
      }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < RT && r0 + r < T; r += vocab::THREADS) {
      float v = rv[r];
      int i = ri[r];
      for (int wi = 1; wi < vocab::NWARP; ++wi) better(v, i, rv[wi * RT + r], ri[wi * RT + r]);
      part_max[(size_t)(r0 + r) * nblk + s] = v;
      part_arg[(size_t)(r0 + r) * nblk + s] = i;
    }
  }
};

// shared memory of pass 1: the ring, then the warps' (max, arg) of each row
template <typename TI, int NT>
constexpr size_t partial_smem() {
  return 1024 + vocab::ring_bytes<TI>(8 * NT) +
         (size_t)vocab::NWARP * 8 * NT * (sizeof(float) + sizeof(int));
}

// Pass 1: the persistent grid streams w and writes part_{max,arg} (T, nstrips).
template <typename TI, int NT>
__global__ void __launch_bounds__(vocab::THREADS)
verify_partial(const TI* __restrict__ h, const TI* __restrict__ w,
               const __grid_constant__ CUtensorMap wmap, vocab::Plan p,
               float* __restrict__ part_max, int* __restrict__ part_arg) {
  extern __shared__ __align__(1024) char smem[];
  char* ring = vocab::align_ring(smem);
  float* rv = reinterpret_cast<float*>(ring + vocab::ring_bytes<TI>(8 * NT));
  int* ri = reinterpret_cast<int*>(rv + vocab::NWARP * 8 * NT);
  ArgmaxEpi<NT> epi{p.T, p.V, p.nstrips, part_max, part_arg, rv, ri};
  vocab::stream<TI, NT>(h, w, &wmap, p, ring, epi);
  vocab::launch_dependents();        // pass 2 may launch once every CTA is here
}

// Pass 2: one block per row reduces the row's nblk partials.
__global__ void __launch_bounds__(256)
verify_reduce(const float* __restrict__ part_max, const int* __restrict__ part_arg, int nblk,
              int* __restrict__ out_arg, float* __restrict__ out_max) {
  __shared__ float sv[8];
  __shared__ int si[8];
  vocab::wait_primary();
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

template <typename TI, int NT>
cudaError_t launch_partial(const TI* h, const TI* w, const CUtensorMap& map,
                           const vocab::Plan& p, float* pm, int* pa, cudaStream_t s) {
  return vocab::launch<verify_partial<TI, NT>>(p, partial_smem<TI, NT>(), false, s, h, w, map,
                                              p, pm, pa);
}

template <typename TI>
cudaError_t run(const void* h, const void* w, const vocab::Plan& p, float* pm, int* pa,
                int* oa, float* om, cudaStream_t s) {
  const TI* hp = static_cast<const TI*>(h);
  const TI* wp = static_cast<const TI*>(w);
  CUtensorMap map{};
  cudaError_t e = sizeof(TI) == 2 && p.fast ? vocab::w_map(&map, w, p.d, p.V) : cudaSuccess;
  if (e != cudaSuccess) return e;
  switch (p.rt / 8) {
    case 1: e = launch_partial<TI, 1>(hp, wp, map, p, pm, pa, s); break;
    case 2: e = launch_partial<TI, 2>(hp, wp, map, p, pm, pa, s); break;
    case 3: e = launch_partial<TI, 3>(hp, wp, map, p, pm, pa, s); break;
    case 4: e = launch_partial<TI, 4>(hp, wp, map, p, pm, pa, s); break;
    case 5: e = launch_partial<TI, 5>(hp, wp, map, p, pm, pa, s); break;
    case 6: e = launch_partial<TI, 6>(hp, wp, map, p, pm, pa, s); break;
    case 7: e = launch_partial<TI, 7>(hp, wp, map, p, pm, pa, s); break;
    default: e = launch_partial<TI, 8>(hp, wp, map, p, pm, pa, s); break;
  }
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.T);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, verify_reduce, (const float*)pm, (const int*)pa, p.nstrips, oa,
                         om);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// fast: 1 takes the 16-byte loader (h and w on 16 bytes, d and V rows of
// 16-byte multiples), 0 the element loader; nblk must be ceil(V / 128).
DVI_EXPORT int dvi_verify_argmax(const void* h, const void* w, int T, int d, int V,
                                 int is_bf16, int fast, void* part_max, void* part_arg,
                                 int nblk, void* out_arg, void* out_max, void* stream) {
  vocab::Plan p{T, d, V, 0, 0, (V + vocab::COLS - 1) / vocab::COLS, 0, fast};
  const int elt = is_bf16 ? 2 : 4;
  if (T <= 0 || d <= 0 || V <= 0 || nblk != p.nstrips) return cudaErrorInvalidValue;
  if (fast && !vocab::fast_ok(h, w, d, V, elt)) return cudaErrorInvalidValue;
  p.nk = (d + 128 / elt - 1) / (128 / elt);
  vocab::plan_rows(p, 8 * vocab::MAX_NT);
  float* pm = static_cast<float*>(part_max);
  int* pa = static_cast<int*>(part_arg);
  int* oa = static_cast<int*>(out_arg);
  float* om = static_cast<float*>(out_max);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(h, w, p, pm, pa, oa, om, s)
                 : run<float>(h, w, p, pm, pa, oa, om, s);
}
