// lora_logits: the LoRA draft head, h@w + gamma*(h@a)@b in float32.
//
// Replaces the Pallas kernel src/repro/kernels/lora_logits.py (lora_logits,
// pallas_call at :53), which computes u = h@a once per row block into VMEM
// scratch at the first vocab tile and reuses it across the sequential vocab
// axis.  Hopper blocks run in no order, so u is formed first, by lora_down:
// a thread block cluster of 8 CTAs splits d, each CTA's 8 warps split its
// share again, and the 64 partial sums of every u[t][j] are added in a fixed
// order (warps in shared memory, then the cluster's ranks in distributed
// shared memory), so u is the same on every call.  The main pass streams w
// through vocab_tile.cuh and, at each strip's epilogue, adds
// gamma * u @ b[:, strip] in float32 to the accumulators before its one
// write of the float32 logits.  It is a programmatic dependent launch: its
// CTAs start streaming w while lora_down runs and wait for u only before
// their first epilogue, so the pre-pass costs no serial time.
//
// Bound on H100: the bytes of w, b and the logits (about 271 MB per launch
// at vicuna-7b in bf16 with T = 8, r = 64, about 81 us at 3.35 TB/s).  At
// T = 8 the products are far below either core's rate, so the design's job
// is to keep enough of w in flight (vocab_tile.cuh) and write the logits once.
#include <cooperative_groups.h>

#include <algorithm>

#include "vocab_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int DOWN_RANKS = 8;       // CTAs of a lora_down cluster, split over d
constexpr int DOWN_WARPS = 16;      // warps of a lora_down CTA, split over its share
constexpr int DOWN_ROWS = 8;        // rows of h a lora_down CTA takes
constexpr int DOWN_CHUNK = 32;      // rows of a that a thread loads at once
constexpr int US_CAP = 8192;        // floats of u rows the main pass holds (32 KB)
constexpr int B_ROWS = 64;          // rows of b's strip the main pass holds (32 KB)

// u[t][j] = sum_k h[t][k] a[k][j] in float32.  Grid (8, ceil(r/32),
// ceil(T/8)) in clusters of (8, 1, 1): rank c takes d-slice c and stages its
// 8 rows of h in shared memory as float32; its warp w takes sub-slice w,
// lane j one column of a.  A thread loads its rows of a (32 at d = 4096)
// before h is staged, so all of its loads are in flight at once: lora_down
// runs beside the main pass, whose streaming of w makes every wait long.
// Each thread sums its sub-slice in k order for the 8 rows, the warps' sums
// are added in warp order, then the ranks' in rank order, rank c writing
// row c of the CTA's 8.
template <typename TI>
__global__ void __launch_bounds__(DOWN_WARPS * 32)
lora_down(const TI* __restrict__ h, const float* __restrict__ a, int T, int d, int r,
          float* __restrict__ u) {
  extern __shared__ __align__(16) float hs[];       // (kr, 8)
  __shared__ float part[DOWN_WARPS][DOWN_ROWS][32];
  __shared__ float sum[DOWN_ROWS][32];
  vocab::launch_dependents();        // the main pass may start streaming w
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.y * 32 + lane, t0 = blockIdx.z * DOWN_ROWS;
  const int kr = (d + DOWN_RANKS - 1) / DOWN_RANKS, k0 = rank * kr;
  const int slice = (kr + DOWN_WARPS - 1) / DOWN_WARPS;
  const int kb = warp * slice, ke = min(min(kr, kb + slice), d - k0);
  float av[DOWN_CHUNK];
  auto load_a = [&](int c) {
#pragma unroll
    for (int q = 0; q < DOWN_CHUNK; ++q)
      av[q] = j < r && c + q < ke ? a[(size_t)(k0 + c + q) * r + j] : 0.f;
  };
  load_a(kb);
  for (int i = threadIdx.x; i < kr * DOWN_ROWS; i += blockDim.x) {
    const int t = i / kr, kk = i % kr;
    hs[kk * DOWN_ROWS + t] =
        t0 + t < T && k0 + kk < d ? to_f32(h[(size_t)(t0 + t) * d + k0 + kk]) : 0.f;
  }
  __syncthreads();
  float acc[DOWN_ROWS];
#pragma unroll
  for (int i = 0; i < DOWN_ROWS; ++i) acc[i] = 0.f;
  for (int c = kb; c < ke; c += DOWN_CHUNK) {
    if (c > kb) load_a(c);
#pragma unroll
    for (int q = 0; q < DOWN_CHUNK; ++q) {
      if (c + q < ke) {
        const float4 x0 = *reinterpret_cast<const float4*>(hs + (c + q) * DOWN_ROWS);
        const float4 x1 = *reinterpret_cast<const float4*>(hs + (c + q) * DOWN_ROWS + 4);
        acc[0] = fmaf(x0.x, av[q], acc[0]);
        acc[1] = fmaf(x0.y, av[q], acc[1]);
        acc[2] = fmaf(x0.z, av[q], acc[2]);
        acc[3] = fmaf(x0.w, av[q], acc[3]);
        acc[4] = fmaf(x1.x, av[q], acc[4]);
        acc[5] = fmaf(x1.y, av[q], acc[5]);
        acc[6] = fmaf(x1.z, av[q], acc[6]);
        acc[7] = fmaf(x1.w, av[q], acc[7]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < DOWN_ROWS; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  if (warp < DOWN_ROWS) {                    // warp i adds row i over the warps
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < DOWN_WARPS; ++wi) s += part[wi][warp][lane];
    sum[warp][lane] = s;
  }
  cluster.sync();
  if (warp == 0 && t0 + rank < T && j < r) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < DOWN_RANKS; ++c)
      s += cluster.map_shared_rank(&sum[0][0], c)[rank * 32 + lane];
    u[(size_t)(t0 + rank) * r + j] = s;
  }
  cluster.sync();      // no CTA leaves while another reads its shared memory
}

// 4 bytes from device to shared memory (cp.async.ca); with `fill` false
// nothing is read and the 4 bytes are zeroed.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 4 : 0));
}

// The epilogue of a (row pass, strip): out = acc + gamma * (u @ b[:, strip])
// in float32, written once.  b's strip comes to shared memory in chunks of
// B_ROWS rows by cp.async: the first chunk is copied at the strip's middle
// k-chunk and lands with the ring's stages, so the epilogue waits for
// nothing on the paths (r <= 64, d long enough); further chunks (r > 64)
// are copied and waited for in the epilogue.  u's rows of a pass are
// copied the same way once lora_down has finished: at the middle of the
// CTA's last strip of the pass (its epilogue being the one that ends the
// kernel), or at the first epilogue that needs them.
template <int NT>
struct LoraEpi {
  const float* u;      // (T, r)
  const float* b;      // (r, V)
  float* out;          // (T, V)
  float gamma;
  int T, V, r, ldu, nstrips;
  bool early;          // b's first chunk lands with the ring's waits
  float* us;           // (RT, ldu) shared
  float* bs;           // (min(r, B_ROWS), COLS) shared
  int us_r0;           // the pass whose rows `us` holds, -1 before the first

  // u's rows from r0 into shared memory, after lora_down (every thread;
  // the copies join the next commit).
  __device__ __forceinline__ void stage_u(int r0) {
    if (us_r0 < 0) vocab::wait_primary();
    for (int i = threadIdx.x; i < 8 * NT * r; i += vocab::THREADS) {
      const int rr = i / r, jj = i % r;
      cp_async4(us + rr * ldu + jj, r0 + rr < T ? u + (size_t)(r0 + rr) * r + jj : u, r0 + rr < T);
    }
    us_r0 = r0;
  }

  // Rows j0 .. j0 + B_ROWS of b's strip s into bs (joins the next commit).
  __device__ __forceinline__ void load_b(int s, int j0) {
    const int c0 = s * vocab::COLS, rows = min(r - j0, B_ROWS);
    for (int i = threadIdx.x; i < rows * vocab::COLS; i += vocab::THREADS) {
      const int jj = i / vocab::COLS, c = c0 + i % vocab::COLS;
      cp_async4(bs + i, c < V ? b + (size_t)(j0 + jj) * V + c : b, c < V);
    }
  }

  __device__ __forceinline__ void mid(int s, int r0) {
    load_b(s, 0);
    if (r0 != us_r0 && s + (int)gridDim.x >= nstrips) stage_u(r0);
  }

  __device__ __forceinline__ void operator()(const float (&acc)[2][NT][4], int s, int r0) {
    bool wait = !early;
    if (r0 != us_r0) {
      stage_u(r0);
      cp_async_commit();
      wait = true;
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float lo[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) lo[mt][nt][e] = 0.f;
    const float* u0 = us + 2 * t * ldu;
    for (int j0 = 0; j0 < r; j0 += B_ROWS) {
      if (j0 > 0) {
        __syncthreads();           // every thread is done with the last chunk
        load_b(s, j0);
        cp_async_commit();
      }
      if (j0 > 0 || wait) cp_async_wait<0>();
      __syncthreads();
      const int rows = min(r - j0, B_ROWS);
      const float* bc = bs + warp * 32 + g;
#pragma unroll 4
      for (int jj = 0; jj < rows; ++jj) {
        float bv[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          bv[mt][0] = bc[jj * vocab::COLS + mt * 16];
          bv[mt][1] = bc[jj * vocab::COLS + mt * 16 + 8];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float x0 = u0[nt * 8 * ldu + j0 + jj], x1 = u0[(nt * 8 + 1) * ldu + j0 + jj];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            lo[mt][nt][0] = fmaf(x0, bv[mt][0], lo[mt][nt][0]);
            lo[mt][nt][1] = fmaf(x1, bv[mt][0], lo[mt][nt][1]);
            lo[mt][nt][2] = fmaf(x0, bv[mt][1], lo[mt][nt][2]);
            lo[mt][nt][3] = fmaf(x1, bv[mt][1], lo[mt][nt][3]);
          }
        }
      }
    }
    const int c0 = s * vocab::COLS + warp * 32 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + nt * 8 + 2 * t + (e & 1), c = c0 + mt * 16 + (e >> 1) * 8;
          if (row < T && c < V) out[(size_t)row * V + c] = acc[mt][nt][e] + gamma * lo[mt][nt][e];
        }
  }
};

// The padded row of u in shared memory: odd, so the four rows a warp reads
// at once fall in different banks.
__host__ __device__ inline int u_ld(int r) { return r | 1; }

// shared memory of the main pass: the ring, u's rows of a pass, b's chunk
template <typename TI, int NT>
size_t main_smem(int r) {
  return 1024 + vocab::ring_bytes<TI>(8 * NT) + (size_t)8 * NT * u_ld(r) * sizeof(float) +
         (size_t)std::min(r, B_ROWS) * vocab::COLS * sizeof(float);
}

template <typename TI, int NT>
__global__ void __launch_bounds__(vocab::THREADS)
lora_main(const TI* __restrict__ h, const TI* __restrict__ w,
          const __grid_constant__ CUtensorMap wmap, const float* __restrict__ u,
          const float* __restrict__ b, float gamma, vocab::Plan p, int r,
          float* __restrict__ out) {
  extern __shared__ __align__(1024) char smem[];
  char* ring = vocab::align_ring(smem);
  float* us = reinterpret_cast<float*>(ring + vocab::ring_bytes<TI>(8 * NT));
  float* bs = us + 8 * NT * u_ld(r);
  LoraEpi<NT> epi{u, b, out, gamma, p.T, p.V, r, u_ld(r), p.nstrips,
                  p.nk - 1 - p.nk / 2 >= vocab::STAGES, us, bs, -1};
  vocab::stream<TI, NT>(h, w, &wmap, p, ring, epi);
}

template <typename TI, int NT>
cudaError_t launch_main(const TI* h, const TI* w, const CUtensorMap& map, const float* u,
                        const float* b, float gamma, const vocab::Plan& p, int r, float* out,
                        cudaStream_t s) {
  return vocab::launch<lora_main<TI, NT>>(p, main_smem<TI, NT>(r), true, s, h, w, map, u, b,
                                          gamma, p, r, out);
}

template <typename TI>
cudaError_t run(const void* h, const void* w, const float* a, const float* b, float gamma,
                const vocab::Plan& p, int r, float* u, float* out, cudaStream_t s) {
  const TI* hp = static_cast<const TI*>(h);
  const TI* wp = static_cast<const TI*>(w);
  CUtensorMap map{};
  if (sizeof(TI) == 2 && p.fast) {
    const cudaError_t e = vocab::w_map(&map, w, p.d, p.V);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DOWN_RANKS, (r + 31) / 32, (p.T + DOWN_ROWS - 1) / DOWN_ROWS);
  cfg.blockDim = dim3(DOWN_WARPS * 32);
  cfg.dynamicSmemBytes = (size_t)(p.d + DOWN_RANKS - 1) / DOWN_RANKS * DOWN_ROWS * sizeof(float);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DOWN_RANKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = allow_smem(lora_down<TI>, cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, lora_down<TI>, hp, a, p.T, p.d, r, u);
  if (e != cudaSuccess || (e = cudaGetLastError()) != cudaSuccess) return e;
  const float* uc = u;
  switch (p.rt / 8) {
    case 1: return launch_main<TI, 1>(hp, wp, map, uc, b, gamma, p, r, out, s);
    case 2: return launch_main<TI, 2>(hp, wp, map, uc, b, gamma, p, r, out, s);
    case 3: return launch_main<TI, 3>(hp, wp, map, uc, b, gamma, p, r, out, s);
    case 4: return launch_main<TI, 4>(hp, wp, map, uc, b, gamma, p, r, out, s);
    case 5: return launch_main<TI, 5>(hp, wp, map, uc, b, gamma, p, r, out, s);
    case 6: return launch_main<TI, 6>(hp, wp, map, uc, b, gamma, p, r, out, s);
    case 7: return launch_main<TI, 7>(hp, wp, map, uc, b, gamma, p, r, out, s);
    default: return launch_main<TI, 8>(hp, wp, map, uc, b, gamma, p, r, out, s);
  }
}

}  // namespace

// fast: 1 takes the 16-byte loader (h and w on 16 bytes, d and V rows of
// 16-byte multiples), 0 the element loader.  u is (T, r) float32 scratch.
DVI_EXPORT int dvi_lora_logits(const void* h, const void* w, const void* a, const void* b,
                               float gamma, int T, int d, int V, int r, int is_bf16, int fast,
                               void* u, void* out, void* stream) {
  vocab::Plan p{T, d, V, 0, 0, (V + vocab::COLS - 1) / vocab::COLS, 0, fast};
  const int elt = is_bf16 ? 2 : 4;
  if (T <= 0 || d <= 0 || V <= 0 || r <= 0 || r > 512) return cudaErrorInvalidValue;
  if (fast && !vocab::fast_ok(h, w, d, V, elt)) return cudaErrorInvalidValue;
  p.nk = (d + 128 / elt - 1) / (128 / elt);
  // rows a pass: at most 64, and their u rows within US_CAP floats
  int cap = US_CAP / u_ld(r) / 8 * 8;
  cap = cap < 8 ? 8 : cap > 8 * vocab::MAX_NT ? 8 * vocab::MAX_NT : cap;
  vocab::plan_rows(p, cap);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* up = static_cast<float*>(u);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(h, w, ap, bp, gamma, p, r, up, op, s)
                 : run<float>(h, w, ap, bp, gamma, p, r, up, op, s);
}
