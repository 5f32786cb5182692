// The streaming body shared by the two vocab kernels (verify_argmax.cu,
// lora_logits.cu): h (T, d) @ w (d, V) one strip of vocab columns at a time,
// handed to the kernel's epilogue in registers, never written as logits.
//
// What bounds them on an H100.  Both read all of w once: d*V elements, 262 MB
// at vicuna-7b in bf16, about 78 us at 3.35 TB/s.  Their T (8 and 40 on the
// paths) is far too small for the products to matter once they run on the
// tensor cores (2*40*4096*32000 flops is about 11 us at 989 TFLOP/s), so the
// design's one job is to keep enough of w in flight, in long runs, on every SM.
//
// Work split.  A strip is COLS = 128 adjacent vocab columns (256 contiguous
// bytes of a row of w in bf16).  The grid is persistent: as many CTAs as fit
// on the card at once (three an SM for verify_argmax at T = 40, two for
// lora_logits, whose epilogue holds b's strip), CTA b walking strips b,
// b + grid, ...; each CTA's work is one flat sequence of stages (row pass,
// strip, k-chunk), so the copies of its next strip are in flight while it
// runs the epilogue of the last one.  Rows of h come in passes of RT = 8*NT
// rows (NT n8 tiles, at most 64 rows): T = 8 and 40 are one pass of one and
// five tiles, other T are cut into equal passes padded with zero rows.
//
// Loads.  A stage is BK rows of w's strip (128 bytes of k: 64 rows in bf16,
// 16 KB) and the matching (RT, BK) slice of h, both in their own dtype, in a
// ring of STAGES = 3 stages in shared memory: two stages (32 KB of w) in
// flight per CTA, 64-96 KB per SM.  With the fast loader, bf16 w comes by
// TMA: thread 0 issues the strip's two 64-column boxes of a stage into an
// mbarrier, with the 128-byte swizzle and zero fill past d and V, from a
// descriptor built on the host; h (and float32 w, padded by 16 bytes a row)
// comes by 16-byte cp.async.cg copies, zero-filled past d and T.  The fast
// loader needs h and w to start on 16 bytes and rows of 16-byte multiples
// (V * elt and d * elt), which the wrapper checks from host integers.  Any
// other shape takes the element loader: plain loads of one element into the
// same layout, the same compute and epilogue.  (On an H100 at 700 W, TMA
// streams w up to 6 % faster than 16-byte cp.async copies did; more stages,
// 256-byte k-chunks and 256-column strips were no faster on both paths'
// shapes; the products add about 3 us to the streaming alone; PERF.md.)
//
// Products.  bf16: the transposed tile D^T = w^T h^T on tensor cores, vocab
// on the M side: mma.sync m16n8k16, A = 16 vocab columns of w read with
// ldmatrix.trans from the [k][n] tile, B = 8 rows of h read with ldmatrix
// from the [t][k] tile, float32 accumulators.  Each warp owns 32 columns (two
// m16 tiles) and all RT rows.  float32: CUDA-core FMAs into the same
// fragment layout (no TF32, which keeps about three digits).
//
// Summation order.  Every column is summed by one lane of one warp, over k
// in ascending k-steps, so equal columns of w give bit-equal logits wherever
// they sit in a strip or a fragment: argmax ties are exact.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace vocab {

constexpr int COLS = 128;           // vocab columns of a strip
constexpr int NWARP = COLS / 32;    // a warp owns two m16 tiles of the strip
constexpr int THREADS = NWARP * 32;
constexpr int STAGES = 3;
constexpr int MAX_NT = 8;           // n8 tiles of h rows a pass: at most 64 rows
constexpr int MAX_SMEM = 227 * 1024;

// The tile geometry of one input dtype: a stage is BK rows of w's strip
// (128 bytes of k) then RT rows of h's (RT, BK) slice, rows padded by 16
// bytes; w_at(kk, cc) is element (k-row kk, strip column cc) of the w tile.
template <typename TI>
struct Geo;

// float32: the w tile padded by 16 bytes a row, copied with cp.async.
template <>
struct Geo<float> {
  static constexpr int CH = 4, BK = 32, LDW = COLS + CH, LDH = BK + CH;
  static constexpr size_t W_BYTES = (size_t)BK * LDW * sizeof(float);
  __host__ __device__ static constexpr size_t stage_bytes(int rt) {
    return W_BYTES + (size_t)rt * LDH * sizeof(float);
  }
  __device__ static int w_at(int kk, int cc) { return kk * LDW + cc; }
};

// bf16: the w tile is COLS / 64 TMA boxes of [BK][64], each row 128 bytes
// with the 128-byte swizzle (16-byte chunk j of row kk stored at chunk
// j ^ (kk % 8)), so the eight rows an ldmatrix reads fall in eight banks;
// a box starts on 1024 bytes, so stages are whole kilobytes.
template <>
struct Geo<__nv_bfloat16> {
  static constexpr int CH = 8, BK = 64, BOX = 64, LDH = BK + CH;
  static constexpr size_t W_BYTES = (size_t)BK * COLS * sizeof(__nv_bfloat16);
  __host__ __device__ static constexpr size_t stage_bytes(int rt) {
    return (W_BYTES + (size_t)rt * LDH * sizeof(__nv_bfloat16) + 1023) / 1024 * 1024;
  }
  __device__ static int w_at(int kk, int cc) {
    return (cc / BOX) * (BK * BOX) + kk * BOX + ((((cc >> 3) & 7) ^ (kk & 7)) << 3) + (cc & 7);
  }
};

// The dynamic shared memory a kernel asks for: its ring and `extra` bytes
// after it, and room to start the ring on 1024 bytes.
template <typename TI>
__host__ __device__ constexpr size_t ring_bytes(int rt) {
  return STAGES * Geo<TI>::stage_bytes(rt);
}
__device__ __forceinline__ char* align_ring(char* smem) {
  return smem + ((1024 - smem_addr(smem) % 1024) % 1024);
}

// What every CTA of a call knows: the shapes, the row passes, the strips.
struct Plan {
  int T, d, V;
  int rt;       // rows of h a pass, a multiple of 8
  int npass;    // ceil(T / rt)
  int nstrips;  // ceil(V / COLS)
  int nk;       // stages a strip: ceil(d / BK)
  int fast;     // 1: the fast loader (TMA, 16-byte cp.async); 0: the element one
};

// The row passes of T rows with at most `cap` rows a pass (cap a multiple
// of 8): equal passes, each rounded up to a multiple of 8.
inline void plan_rows(Plan& p, int cap) {
  p.npass = (p.T + cap - 1) / cap;
  const int rows = (p.T + p.npass - 1) / p.npass;
  p.rt = (rows + 7) / 8 * 8;
}

// Whether the fast loader may take these operands (the wrapper's
// `vocab_fast` is the host's copy of this rule).
inline bool fast_ok(const void* h, const void* w, int d, int V, int elt) {
  return reinterpret_cast<uintptr_t>(h) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
         (size_t)d * elt % 16 == 0 && (size_t)V * elt % 16 == 0;
}

// Programmatic dependent launch: a primary lets its dependent grid start;
// the dependent waits for the primary's completion and its memory.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The TMA descriptor of w (d, V) in bf16: boxes of BK rows by 64 columns,
// 128-byte swizzle, zero fill past d and V.  cuTensorMapEncodeTiled is a
// driver function, reached through the runtime; the last descriptor is kept,
// since a path calls with the same w again and again (static: each library
// keeps its own).
static inline cudaError_t w_map(CUtensorMap* map, const void* w, int d, int V) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  static CUtensorMap last;
  static const void* last_w = nullptr;
  static int last_d = 0, last_V = 0;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
  }
  if (w != last_w || d != last_d || V != last_V) {
    using G = Geo<__nv_bfloat16>;
    const cuuint64_t dims[2] = {(cuuint64_t)V, (cuuint64_t)d};
    const cuuint64_t strides[1] = {(cuuint64_t)V * sizeof(__nv_bfloat16)};
    const cuuint32_t box[2] = {G::BOX, G::BK}, unit[2] = {1, 1};
    if (encode(&last, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
        CUDA_SUCCESS) {
      last_w = nullptr;
      return cudaErrorInvalidValue;
    }
    last_w = w;
    last_d = d;
    last_V = V;
  }
  *map = last;
  return cudaSuccess;
}

// Wait until the mbarrier at shared address `bar` has completed the phase
// of the given parity.  A copy that never lands traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1L << 22)) __trap();
  }
}

// Copy stage (strip s, rows from r0, k from k0) into `slot`.  bf16 with the
// fast loader: thread 0 arms the slot's mbarrier `bar` for the w tile's
// bytes and issues its TMA boxes; everything else goes by cp.async (fast)
// or by plain loads (element loader).
template <typename TI>
__device__ __forceinline__ void load_stage(char* slot, const TI* __restrict__ h,
                                           const TI* __restrict__ w, const CUtensorMap* wmap,
                                           uint64_t* bar, const Plan& p, int rt, int s, int r0,
                                           int k0) {
  using G = Geo<TI>;
  TI* ws = reinterpret_cast<TI*>(slot);
  TI* hs = reinterpret_cast<TI*>(slot + G::W_BYTES);
  const int c0 = s * COLS;
  if (p.fast) {
    constexpr int HCH = G::BK / G::CH;
    if constexpr (sizeof(TI) == 2) {
      if (threadIdx.x == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(smem_addr(bar)), "r"((uint32_t)G::W_BYTES) : "memory");
#pragma unroll
        for (int b = 0; b < COLS / G::BOX; ++b)
          asm volatile(
              "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
              " [%0], [%1, {%2, %3}], [%4];\n"
              ::"r"(smem_addr(ws + b * G::BK * G::BOX)), "l"(reinterpret_cast<uint64_t>(wmap)),
                "r"(c0 + b * G::BOX), "r"(k0), "r"(smem_addr(bar)) : "memory");
      }
    } else {
      constexpr int WCH = COLS / G::CH;
      for (int i = threadIdx.x; i < G::BK * WCH; i += THREADS) {
        const int kk = i / WCH, cc = (i % WCH) * G::CH;
        const int k = k0 + kk, c = c0 + cc;
        const bool in = k < p.d && c < p.V;
        cp_async16(ws + G::w_at(kk, cc), in ? w + (size_t)k * p.V + c : w, in);
      }
    }
    for (int i = threadIdx.x; i < rt * HCH; i += THREADS) {
      const int rr = i / HCH, kk = (i % HCH) * G::CH;
      const int row = r0 + rr, k = k0 + kk;
      const bool in = row < p.T && k < p.d;
      cp_async16(hs + rr * G::LDH + kk, in ? h + (size_t)row * p.d + k : h, in);
    }
  } else {
    const TI zero = from_f32<TI>(0.f);
    for (int i = threadIdx.x; i < G::BK * COLS; i += THREADS) {
      const int kk = i / COLS, cc = i % COLS;
      const int k = k0 + kk, c = c0 + cc;
      ws[G::w_at(kk, cc)] = k < p.d && c < p.V ? w[(size_t)k * p.V + c] : zero;
    }
    for (int i = threadIdx.x; i < rt * G::BK; i += THREADS) {
      const int rr = i / G::BK, kk = i % G::BK;
      const int row = r0 + rr, k = k0 + kk;
      hs[rr * G::LDH + kk] = row < p.T && k < p.d ? h[(size_t)row * p.d + k] : zero;
    }
  }
}

// acc[mt][nt] += the fragment of (m16 tile mt of this warp) x (n8 tile nt)
// over one stage.  Lane (g = lane / 4, t = lane % 4) holds, for column
// c = warp*32 + mt*16 + g and row r = nt*8 + 2t: {(c, r), (c, r+1), (c+8, r),
// (c+8, r+1)}.
template <int NT>
__device__ __forceinline__ void stage_products(float (&acc)[2][NT][4],
                                               const __nv_bfloat16* ws,
                                               const __nv_bfloat16* hs, int warp, int lane) {
  using G = Geo<__nv_bfloat16>;
  const int mi = lane >> 3, ri = lane & 7;
  // A = w^T: matrix mi of ldmatrix.trans holds k rows (mi >> 1)*8 + ri at
  // the 16-byte chunk of vocab columns warp*32 + mt*16 + (mi & 1)*8; every
  // k-step moves the rows by multiples of 8, so the row's swizzle is ri.
  // B = h^T: matrix mi holds row ri of an n8 tile at k columns mi*8, so one
  // x4 load gives two k-steps.
  const __nv_bfloat16* wa[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    wa[mt] = ws + G::w_at((mi >> 1) * 8 + ri, warp * 32 + mt * 16 + (mi & 1) * 8);
  const __nv_bfloat16* hb = hs + ri * G::LDH + mi * 8;
#pragma unroll
  for (int k2 = 0; k2 < G::BK; k2 += 32) {
    uint32_t a[2][2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4_trans(a[ks][mt], wa[mt] + (k2 + ks * 16) * G::BOX);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b[4];
      ldmatrix_x4(b, hb + nt * 8 * G::LDH + k2);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16_16816(acc[mt][nt], a[0][mt], b[0], b[1]);
        mma_bf16_16816(acc[mt][nt], a[1][mt], b[2], b[3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void stage_products(float (&acc)[2][NT][4], const float* ws,
                                               const float* hs, int warp, int lane) {
  using G = Geo<float>;
  const int g = lane >> 2, t = lane & 3;
  const float* wc = ws + warp * 32 + g;
  const float* hr = hs + 2 * t * G::LDH;
#pragma unroll 4
  for (int kk = 0; kk < G::BK; ++kk) {
    float wv[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      wv[mt][0] = wc[kk * G::LDW + mt * 16];
      wv[mt][1] = wc[kk * G::LDW + mt * 16 + 8];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float x0 = hr[nt * 8 * G::LDH + kk], x1 = hr[(nt * 8 + 1) * G::LDH + kk];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        acc[mt][nt][0] = fmaf(x0, wv[mt][0], acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf(x1, wv[mt][0], acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf(x0, wv[mt][1], acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf(x1, wv[mt][1], acc[mt][nt][3]);
      }
    }
  }
}

// Stream this CTA's stages through the ring.  For each (pass, strip s) at
// rows r0, every thread calls epi.mid(s, r0) after the products of its
// middle k-chunk (the ring's next stages are in flight meanwhile), then
// epi(acc, s, r0) after its last, and starts the next with zeroed
// accumulators.  `ring` (on 1024 bytes) holds ring_bytes<TI>(8 * NT).
template <typename TI, int NT, typename Epi>
__device__ __forceinline__ void stream(const TI* __restrict__ h, const TI* __restrict__ w,
                                       const CUtensorMap* wmap, const Plan& p, char* ring,
                                       Epi& epi) {
  using G = Geo<TI>;
  constexpr int RT = 8 * NT;
  constexpr size_t SB = G::stage_bytes(RT);
  __shared__ __align__(8) uint64_t bars[STAGES];   // the w tiles' TMA arrivals
  const bool tma = sizeof(TI) == 2 && p.fast;
  if (tma) {
    if (threadIdx.x == 0)
      for (int i = 0; i < STAGES; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bars[i]))
                     : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mine = (p.nstrips - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int items = p.npass * mine * p.nk;
  // item i -> (strip, rows from r0, k-chunk), passes outermost
  auto strip = [&](int i) { return (int)blockIdx.x + (i / p.nk % mine) * (int)gridDim.x; };
  auto row0 = [&](int i) { return i / p.nk / mine * RT; };
  auto issue = [&](int i) {
    if (i < items)
      load_stage<TI>(ring + (i % STAGES) * SB, h, w, wmap, &bars[i % STAGES], p, RT, strip(i),
                     row0(i), i % p.nk * G::BK);
    cp_async_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int i = 0; i < items; ++i) {
    cp_async_wait<STAGES - 2>();
    if (tma) mbar_wait(smem_addr(&bars[i % STAGES]), (i / STAGES) & 1);
    __syncthreads();             // stage i landed for all; slot i-1 is free
    issue(i + STAGES - 1);
    const char* slot = ring + (i % STAGES) * SB;
    stage_products<NT>(acc, reinterpret_cast<const TI*>(slot),
                       reinterpret_cast<const TI*>(slot + G::W_BYTES), warp, lane);
    const int kc = i % p.nk;
    if (kc == p.nk / 2) epi.mid(strip(i), row0(i));
    if (kc == p.nk - 1) {
      epi(acc, strip(i), row0(i));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
  cp_async_wait<0>();
}

// Launch Kernel<<<grid, THREADS, smem, s>>> with the persistent grid: as
// many CTAs as fit on the card at once, at most one a strip.  With `pdl` the
// launch may begin before the previous kernel on the stream has finished
// (programmatic dependent launch); the kernel waits for it with
// wait_primary() before it reads what that kernel writes.
template <auto Kernel, typename... A>
cudaError_t launch(const Plan& p, size_t smem, bool pdl, cudaStream_t s, A&&... args) {
  // the dynamic limit leaves room for the kernel's static shared memory
  static size_t fixed = 0;
  static const cudaError_t limit = [] {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, Kernel);
    if (e != cudaSuccess) return e;
    fixed = fa.sharedSizeBytes;
    return cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                MAX_SMEM - (int)fixed);
  }();
  if (limit != cudaSuccess) return limit;
  if (smem + fixed > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static int sms = 0;
  static size_t occ_smem = 0;
  static int occ = 0;
  cudaError_t e;
  if (sms == 0) {
    int dev;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
  }
  if (occ_smem != smem || occ == 0) {
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, Kernel, THREADS, smem)) !=
        cudaSuccess)
      return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    occ_smem = smem;
  }
  const int grid = p.nstrips < occ * sms ? p.nstrips : occ * sms;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, Kernel, static_cast<A&&>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace vocab
