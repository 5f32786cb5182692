// ssd_scan: the Mamba-2 SSD chunked scan with a carried float32 state.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// pallas_call at :80), whose grid (B, T/Q) walks the chunks of a sequence
// in order with the (H, hd, ds) state in VMEM scratch.  It computes what
// repro.models.ssm.ssd_chunked computes, in float32, for G = 1: per chunk
// of Q rows (cum = inclusive cumsum of dt*A over the chunk, cl = cum[Q-1])
//
//   y[i]  = sum_{j<=i} W[i][j] x_j,  W[i][j] = (C_i.B_j) exp(cum_i - cum_j) dt_j
//         + exp(cum_i) C_i . h                                 (carried state)
//   h    <- h exp(cl) + sum_j B_j (x) u_j x_j,  u_j = exp(cl - cum_j) dt_j
//
// Work split.  The rows p of hd are independent in all three terms: only
// cum, dt, u and C.B^T are shared, and those are cheap to recompute.  So
// each (head, lane) is split over P CTAs by slices of PW = hd / P columns
// (grid (P, H, B)); P comes from the host (ops.ssd_plan) so that B = 1
// admissions fill the card too.  A CTA walks the chunks of its lane in
// order and keeps its PW x ds float32 state slice in registers (8 KB at
// PW 16, ds 128), one 16-row s tile a warp.  The chunk's C and B rows and
// x's slice go to shared memory by 16-byte cp.async copies (element by
// element where rows are off 16 bytes); every CTA of a lane copies the
// same C and B rows, from another starting point.
//
// Products.  All four run on the tensor cores, mma.sync m16n8k16 in bf16
// with float32 accumulation, fed by ldmatrix, each warp owning one 16-row
// tile (row tiles of y, s tiles of the state):
//   1. S = C.B^T (i x j over ds), tiles on and below the diagonal;
//   2. y += W.x  (i x p over j), W built from S's accumulators in registers;
//   3. y += exp(cum_i) C.h^T (i x p over ds), only on a chunk that starts
//      from a state that may be nonzero: never on the first chunk without h0,
//      which is every prefill of the model paths;
//   4. h^T <- h^T exp(cl) + B^T.(u x) (s x p over j), u x formed once per
//      chunk for all warps.
// In 1 and 2, row tile i takes i + 1 tiles; the heavy tiles hand their
// first ones to the warp of the light tile opposite, which
// passes its partial sums through shared memory, so no warp takes more than
// ceil((nt + 1) / 2) of nt tiles.
// x, B and C are exact in bf16 on the path.  The float32 operands (W, h and
// u x) are split into bf16 terms, v = v0 + v1 + v2 (each the bf16 rounding
// of what the earlier ones leave), and a product a.b is the sum of the
// terms a_u.b_v with u + v <= 2, smallest first: W and h take three terms,
// u x two (the emulation in scripts/torch_ssd_split_error.py shows two
// terms of W alone use most of the tolerance).  Float32 inputs (on no
// model path) split x, B and C into three terms too.
//
// Edges.  A chunk's rows are padded to a whole 16-row tile and ds to 16
// columns, with zeros in shared memory; padded rows carry dt = 0, so they
// add exactly 0 to y and to the state, as rows a caller pads with dt = 0 do.
// Above the diagonal exp(cum_i - cum_j) overflows: the decay is a select,
// never a product with a mask.  cum is a warp-level inclusive scan in row
// order.  C.B^T is the same for every head (G = 1), yet every CTA computes
// it from the chunk in shared memory: a pre-pass into a float32 scratch read
// from L2 was slower at every shape a path launches (PERF.md).
//
// Bound on H100: at the sync prefill shape (B 8, T = Q = 127, H 32, hd 64,
// ds 128, bf16 inputs) the scan reads about 4.8 MB and writes 8.3 MB of
// float32 y and 8.4 MB of float32 state: 21.5 MB, 0.0064 ms at 3.35 TB/s.
// Its products at the split's count come to about 1.9 GFLOP of bf16 tensor
// work, 0.0019 ms at 989 TFLOP/s, so bytes bound it.  The kernel is far
// from it (PERF.md): every CTA of a lane stages the same C and B rows from
// L2 and recomputes C.B^T, and a CTA's chunk is a chain of dependent steps.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;                  // 8 warps: one 16-row tile each
constexpr int MAX_Q = 128;                    // chunk rows: 8 tiles of 16
constexpr int MAX_DS = 128;                   // state columns: 8 tiles of 16
constexpr int NH = 3;                         // bf16 terms of the state h in C.h^T
constexpr int NW = 3;                         // bf16 terms of W

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Args {
  const void* xh;
  const void* Bc;
  const void* Cc;
  const float* dt;
  const float* A;
  const float* h0;                            // (B, H, hd, ds) or null
  long long sxb, sxt, sbb, sbt, scb, sct;     // batch and time strides, elements
  int T, H, hd, ds, Q;
  float* y;
  float* hout;
};

// Shared memory of a CTA: C and B rows of the chunk (qp x ldc, in the input
// type), x's slice (qp x ldx), the float32 state slice h (pw x ldh), the
// helpers' partial y (up to 4 tiles of 16 x pw float32), cum, u and dt (qp
// each).  Row pitches of the ldmatrix operands are an odd number of 16-byte
// units and h's is 8 floats past a multiple of 32, so the fragment reads
// are free of bank conflicts.  At PW 32, Q 128 and ds 128 in bf16 it takes
// 105 KB, two CTAs an SM.  After a chunk's y, the C rows' space holds the
// state update's operand u x as bf16 terms (3 x qp x ldu at most).
struct Smem {
  int qp, dsp, ldc, ldx, ldh, ldu;
  size_t c, b, x, h, part, cum, u, dt, total;
};

__host__ __device__ inline int odd_pitch(int cols, int tsize) {
  const int per = 16 / tsize;                 // elements of a 16-byte unit
  const int units = (cols + per - 1) / per;
  return (units % 2 ? units : units + 1) * per;
}

__host__ __device__ inline Smem smem_layout(int Q, int ds, int pw, int tsize) {
  Smem L;
  L.qp = (Q + 15) / 16 * 16;
  L.dsp = (ds + 15) / 16 * 16;
  L.ldc = odd_pitch(L.dsp, tsize);
  L.ldx = odd_pitch(pw, tsize);
  L.ldh = L.dsp + 8;
  L.ldu = odd_pitch(pw, 2);
  L.c = 0;
  const size_t c_bytes = (size_t)L.qp * L.ldc * tsize;
  const size_t ux_bytes = (size_t)(tsize == 4 ? 3 : 2) * L.qp * L.ldu * 2;   // u x's terms
  L.b = L.c + align16(c_bytes > ux_bytes ? c_bytes : ux_bytes);
  L.x = L.b + align16((size_t)L.qp * L.ldc * tsize);
  L.h = L.x + align16((size_t)L.qp * L.ldx * tsize);
  L.part = L.h + align16((size_t)pw * L.ldh * 4);
  L.cum = L.part + align16((size_t)(MAX_Q / 32) * 16 * pw * 4);
  L.u = L.cum + align16((size_t)L.qp * 4);
  L.dt = L.u + align16((size_t)L.qp * 4);
  L.total = L.dt + align16((size_t)L.qp * 4);
  return L;
}

// ---- operands of mma.sync m16n8k16 ----
//
// A fragment (16 x 16): lane (g, t) holds {A[g][2t..], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]}; B fragment (16 x 8): {B[2t..][g],
// B[2t+8..][g]} (common.cuh).  A float32 operand enters as N bf16 terms.

// v0, v1 as N bf16 pairs: term n is the rounding of what terms < n leave.
template <int N, int R>
__device__ __forceinline__ void split_pair(uint32_t (&out)[N][R], int r, float v0, float v1) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(v0, v1);
    out[n][r] = *reinterpret_cast<const uint32_t*>(&hb);
    v0 -= __low2float(hb);
    v1 -= __high2float(hb);
  }
}

// Two 8x8 b16 matrices, transposed (lanes 0-15 give the row addresses);
// the x4 forms are in common.cuh.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// Two values at p[0] and p[1] (contiguous) or p[0] and p[ld] (strided).
template <bool CONTIG, typename T>
__device__ __forceinline__ float2 pair(const T* p, int ld) {
  if (CONTIG && std::is_same<T, float>::value)
    return *reinterpret_cast<const float2*>(p);
  return make_float2(to_f32(p[0]), to_f32(p[CONTIG ? 1 : ld]));
}

// The generic fragment loads, for float32 inputs: element (m, k) of A at
// base[m * ld + k] (KCONTIG) or base[k * ld + m]; element (k, n) of B at
// base[n * ld + k] (KCONTIG) or base[k * ld + n].
template <int N, bool KCONTIG, typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[N][4], const T* base, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = g + 8 * (q & 1), k = 2 * t + 8 * (q >> 1);
    const float2 v =
        KCONTIG ? pair<true>(base + m * ld + k, 1) : pair<false>(base + k * ld + m, ld);
    split_pair<N, 4>(a, q, v.x, v.y);
  }
}
template <int N, bool KCONTIG, typename T>
__device__ __forceinline__ void load_b(uint32_t (&b)[N][2], const T* base, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = 2 * t + 8 * q;
    const float2 v =
        KCONTIG ? pair<true>(base + g * ld + k, 1) : pair<false>(base + k * ld + g, ld);
    split_pair<N, 2>(b, q, v.x, v.y);
  }
}

// A of a tile stored with k contiguous (C rows for C.B^T and C.h^T).
template <int NI, typename T>
__device__ __forceinline__ void frag_a_krow(uint32_t (&a)[NI][4], const T* base, int ld,
                                            int lane) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    ldmatrix_x4(a[0], base + (lane % 16) * ld + (lane / 16) * 8);
  else
    load_a<NI, true>(a, base, ld, lane);
}

// A of a tile stored with m contiguous (B^T for the state update: element
// (m = s, k = j) at base[j * ld + s]).
template <int NI, typename T>
__device__ __forceinline__ void frag_a_mrow(uint32_t (&a)[NI][4], const T* base, int ld,
                                            int lane) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    ldmatrix_x4_trans(a[0], base + ((lane % 8) + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2));
  else
    load_a<NI, false>(a, base, ld, lane);
}

// B of two n8 tiles stored with k contiguous, n rows (B rows for C.B^T).
template <int NI, typename T>
__device__ __forceinline__ void frag_b_nrow(uint32_t (&b)[2][NI][2], const T* base, int ld,
                                            int lane) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    uint32_t r[4];
    ldmatrix_x4(r, base + ((lane % 8) + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2));
    b[0][0][0] = r[0], b[0][0][1] = r[1], b[1][0][0] = r[2], b[1][0][1] = r[3];
  } else {
    load_b<NI, true>(b[0], base, ld, lane);
    load_b<NI, true>(b[1], base + 8 * ld, ld, lane);
  }
}

// B of NT <= 2 n8 tiles stored with n contiguous, k rows (x for W.x, one
// bf16 term of u x for the state update).
template <int N, int NT, typename T>
__device__ __forceinline__ void frag_b_krow(uint32_t (&b)[NT][N][2], const T* base, int ld,
                                            int lane) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    uint32_t r[2 * NT];
    if constexpr (NT == 2)
      ldmatrix_x4_trans(r, base + ((lane % 8) + 8 * ((lane / 8) % 2)) * ld + 8 * (lane / 16));
    else
      ldmatrix_x2_trans(r, base + ((lane % 8) + 8 * ((lane / 8) % 2)) * ld);
#pragma unroll
    for (int n = 0; n < NT; ++n) b[n][0][0] = r[2 * n], b[n][0][1] = r[2 * n + 1];
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) load_b<N, false>(b[n], base + 8 * n, ld, lane);
  }
}

// d += a.b over the term pairs (u, v) with u + v <= 2, smallest first.
template <int NA, int NB>
__device__ __forceinline__ void mma_terms(float (&d)[4], const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
#pragma unroll
  for (int o = 2; o >= 0; --o) {
#pragma unroll
    for (int u = 0; u < NA; ++u) {
      const int v = o - u;
      if (v >= 0 && v < NB) mma_bf16_16816(d, a[u], b[v][0], b[v][1]);
    }
  }
}

// dst[r * ld + c] = src[r * stride + c] for r < valid and c < cols, else 0,
// over rows x colsp (both padded); 16-byte cp.async copies (zero-filled
// past the edges) when `vec`, so every copy of a thread is in flight at
// once.  The CTAs of a lane copy the same C and B rows: each starts at
// another 16-byte unit, so they do not all ask one L2 slice at once.  The
// caller waits (cp_async_wait<0>) and synchronises.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, long long stride, int rows,
                                      int valid, int cols, int colsp, bool vec) {
  constexpr int PER = 16 / sizeof(T);
  if (vec) {
    const int cpr = colsp / PER, n = rows * cpr;
    const int rot = (int)((blockIdx.y * gridDim.x + blockIdx.x) * 97u % (unsigned)n);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int e = i + rot < n ? i + rot : i + rot - n;
      const int r = e / cpr, c = (e % cpr) * PER;
      const bool in = r < valid && c < cols;
      cp_async16(dst + r * ld + c, in ? src + r * stride + c : src, in);
    }
    cp_async_commit();
  } else {
    for (int e = threadIdx.x; e < rows * colsp; e += THREADS) {
      const int r = e / colsp, c = e % colsp;
      dst[r * ld + c] = r < valid && c < cols ? src[r * stride + c] : from_f32<T>(0.f);
    }
  }
}

// S (16 x 16) = C rows [i0, i0+16) . B rows [j0, j0+16)^T from shared memory.
// The k steps alternate between two sets of accumulators, so two chains of
// mma.sync are in flight.
template <int NI, typename T>
__device__ __forceinline__ void cb_tile(float (&s)[2][4], const T* cs, const T* bs, int ld,
                                        int dsp, int i0, int j0, int lane) {
  float s2[2][2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s2[h][nb][e] = 0.f;
  for (int k0 = 0; k0 < dsp; k0 += 32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (k0 + 16 * h < dsp) {
        uint32_t ca[NI][4];
        uint32_t bb[2][NI][2];
        frag_a_krow<NI>(ca, cs + i0 * ld + k0 + 16 * h, ld, lane);
        frag_b_nrow<NI>(bb, bs + j0 * ld + k0 + 16 * h, ld, lane);
        mma_terms(s2[h][0], ca, bb[0]);
        mma_terms(s2[h][1], ca, bb[1]);
      }
    }
  }
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = s2[0][nb][e] + s2[1][nb][e];
}

template <typename T>
__device__ __forceinline__ bool vec_ok(const Args& a) {
  const long long m = (long long)(reinterpret_cast<uintptr_t>(a.xh) |
                                  reinterpret_cast<uintptr_t>(a.Bc) |
                                  reinterpret_cast<uintptr_t>(a.Cc)) |
                      ((a.sxb | a.sxt | a.sbb | a.sbt | a.scb | a.sct) * (long long)sizeof(T));
  return (m & 15) == 0;
}

// acc += W.x over j tiles [jt_lo, jt_hi] of the 16 rows from i0, with W
// built in registers from C.B^T's accumulators.
template <int NI, int NP, int NT, typename T>
__device__ __forceinline__ void intra_tiles(float (&acc)[NP][4], const T* cs, const T* bs,
                                            const T* xs, const float* cum, const float* dts,
                                            const Smem& L, int i0, int jt_lo, int jt_hi,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float ci[2] = {cum[i0 + g], cum[i0 + g + 8]};
  for (int j0 = 16 * jt_lo; j0 <= 16 * jt_hi; j0 += 16) {
    float s[2][4];
    cb_tile<NI>(s, cs, bs, L.ldc, L.dsp, i0, j0, lane);
    // W in the A layout: register q holds row g + 8 (q & 1), columns
    // 8 (q >> 1) + 2t and +1: S's n8 tile q >> 1, elements 2 (q & 1), +1
    uint32_t wa[NW][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int hi = q & 1, nb = q >> 1, i = i0 + g + 8 * hi;
      float w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 8 * nb + 2 * t + e;
        w[e] = j <= i ? s[nb][2 * hi + e] * __expf(ci[hi] - cum[j]) * dts[j] : 0.f;
      }
      split_pair<NW, 4>(wa, q, w[0], w[1]);
    }
#pragma unroll
    for (int n = 0; n < NP; n += NT) {
      uint32_t xb[NT][NI][2];
      frag_b_krow<NI, NT>(xb, xs + j0 * L.ldx + 8 * n, L.ldx, lane);
#pragma unroll
      for (int m = 0; m < NT; ++m) mma_terms(acc[n + m], wa, xb[m]);
    }
  }
}

// The state slice h[p][s] at hs[p * ldh + s], for the next chunk's C.h^T;
// st holds h^T as in ssd_chunks.
template <int NP>
__device__ __forceinline__ void store_state(float* hs, int ldh, const float (&st)[NP][4],
                                            int s0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hs[(8 * n + 2 * t + (e & 1)) * ldh + s0 + g + 8 * (e >> 1)] = st[n][e];
}

// The main pass.  grid (P, H, B): CTA (pi, h, b) owns columns
// [pi * PW, (pi+1) * PW) of head h on lane b and walks its chunks in order.
// bf16 inputs fit two CTAs an SM (registers capped at 128, shared memory
// under half the SM's).
template <typename T, int PW>
__global__ void __launch_bounds__(THREADS, std::is_same<T, float>::value ? 1 : 2)
    ssd_chunks(const Args a) {
  constexpr int NI = std::is_same<T, float>::value ? 3 : 1;   // terms of x, B, C
  constexpr int NX = NI == 3 ? 3 : 2;                         // terms of u x
  constexpr int NP = PW / 8;                                  // n8 tiles of the slice
  constexpr int NT = NP < 2 ? NP : 2;                         // n8 tiles a B load takes
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(a.Q, a.ds, PW, sizeof(T));
  T* cs = reinterpret_cast<T*>(smem + L.c);
  T* bs = reinterpret_cast<T*>(smem + L.b);
  T* xs = reinterpret_cast<T*>(smem + L.x);
  float* hs = reinterpret_cast<float*>(smem + L.h);
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* us = reinterpret_cast<float*>(smem + L.u);
  float* dts = reinterpret_cast<float*>(smem + L.dt);
  const int pi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int Q = a.Q, qp = L.qp, dsp = L.dsp, ds = a.ds, hd = a.hd, nc = a.T / Q;
  const int p0 = pi * PW;
  const float A_h = a.A[h];
  const bool vec = vec_ok<T>(a);
  const T* xg = static_cast<const T*>(a.xh) + b * a.sxb + (long long)h * hd + p0;
  const T* bg = static_cast<const T*>(a.Bc) + b * a.sbb;
  const T* cgm = static_cast<const T*>(a.Cc) + b * a.scb;
  const size_t hbase = ((size_t)b * a.H + h) * hd + p0;        // row p0 of (b, h)'s state

  // the state slice h^T in registers: warp w owns rows s in [16w, 16w+16),
  // lane (g, t) element (s = 16w + g + 8 (e >> 1), p = 8n + 2t + (e & 1))
  // in st[n][e]; columns s >= ds stay 0
  const int s0 = warp * 16;
  const bool owns_s = s0 < dsp;
  float st[NP][4];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 8 * n + 2 * t + (e & 1), s = s0 + g + 8 * (e >> 1);
      st[n][e] = a.h0 && owns_s && s < ds ? a.h0[(hbase + p) * ds + s] : 0.f;
    }
  if (a.h0 && owns_s) store_state(hs, L.ldh, st, s0, lane);

  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * Q;
    const bool carried = c > 0 || a.h0 != nullptr;
    __syncthreads();                          // the previous chunk is done with smem
    float dtr[4];                             // warp 0: dt of rows 4 lane .. 4 lane + 3
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * lane + r;
        dtr[r] = j < Q ? a.dt[((size_t)b * a.T + t0 + j) * a.H + h] : 0.f;
      }
    }
    stage(cs, L.ldc, cgm + t0 * a.sct, a.sct, qp, Q, ds, dsp, vec);
    stage(bs, L.ldc, bg + t0 * a.sbt, a.sbt, qp, Q, ds, dsp, vec);
    stage(xs, L.ldx, xg + t0 * a.sxt, a.sxt, qp, Q, PW, PW, vec);
    if (warp == 0) {
      // the inclusive cumsum of dt A in row order, as a sequential sum adds
      // it: lane k takes the running sum from lane k-1 and adds its own rows
      // one by one
      float da[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (4 * lane + r < qp) dts[4 * lane + r] = dtr[r];
        da[r] = dtr[r] * A_h;
      }
      float run = 0.f, v[4];
      for (int k = 0; k * 4 < qp; ++k) {
        const float prev = __shfl_sync(0xffffffffu, run, k > 0 ? k - 1 : 0);
        if (lane == k) {
          run = k > 0 ? prev : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            run += da[r];
            v[r] = run;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * lane + r < qp) cum[4 * lane + r] = v[r];
      __syncwarp();
      const float cl = cum[Q - 1];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * lane + r;
        if (j < qp) us[j] = expf(cl - cum[j]) * dts[j];
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // ---- y: warp w owns rows [16w, 16w+16) of the chunk.  The j tiles of a
    // row tile grow with its row, so a heavy tile's first tiles go to the
    // warp of the light tile opposite it (nt - 1 - w), which passes its
    // partial sums through shared memory: at most ceil((nt + 1) / 2) tiles
    // a warp instead of nt.
    const int nt = qp / 16, i0 = warp * 16;
    const int own_lo = 2 * warp + 1 > nt ? (2 * warp + 1 - nt) / 2 : 0;
    const int helped = nt - 1 - warp;         // the tile this warp helps with
    const int help_k = warp < nt && 2 * helped + 1 > nt ? (2 * helped + 1 - nt) / 2 : 0;
    float* part = reinterpret_cast<float*>(smem + L.part) + (size_t)warp * 16 * PW;
    if (help_k > 0) {
      float hacc[NP][4];
#pragma unroll
      for (int n = 0; n < NP; ++n) hacc[n][0] = hacc[n][1] = hacc[n][2] = hacc[n][3] = 0.f;
      intra_tiles<NI, NP, NT>(hacc, cs, bs, xs, cum, dts, L, 16 * helped, 0, help_k - 1,
                              lane);
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(g + 8 * (e >> 1)) * PW + 8 * n + 2 * t + (e & 1)] = hacc[n][e];
    }
    float acc[NP][4];
#pragma unroll
    for (int n = 0; n < NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (i0 < qp) {
      if (carried) {                          // exp(cum_i) C_i . h
        for (int k0 = 0; k0 < dsp; k0 += 16) {
          uint32_t ca[NI][4];
          frag_a_krow<NI>(ca, cs + i0 * L.ldc + k0, L.ldc, lane);
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            uint32_t hb[NH][2];
            load_b<NH, true>(hb, hs + 8 * n * L.ldh + k0, L.ldh, lane);
            mma_terms(acc[n], ca, hb);
          }
        }
        const float e0 = expf(cum[i0 + g]), e1 = expf(cum[i0 + g + 8]);
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          acc[n][0] *= e0;
          acc[n][1] *= e0;
          acc[n][2] *= e1;
          acc[n][3] *= e1;
        }
      }
      intra_tiles<NI, NP, NT>(acc, cs, bs, xs, cum, dts, L, i0, own_lo, warp, lane);
    }
    __syncthreads();                          // the helpers' sums are in; hs is read
    if (i0 < qp) {
      const float* hp =
          reinterpret_cast<const float*>(smem + L.part) + (size_t)(nt - 1 - warp) * 16 * PW;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int i = i0 + g + 8 * hi;
        if (i < Q) {
          float* yr = a.y + (((size_t)b * a.T + t0 + i) * a.H + h) * hd + p0 + 2 * t;
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            float2 v = make_float2(acc[n][2 * hi], acc[n][2 * hi + 1]);
            if (own_lo > 0) {
              v.x += hp[(g + 8 * hi) * PW + 8 * n + 2 * t];
              v.y += hp[(g + 8 * hi) * PW + 8 * n + 2 * t + 1];
            }
            *reinterpret_cast<float2*>(yr + 8 * n) = v;
          }
        }
      }
    }

    // ---- the state: h^T <- h^T exp(cl) + B^T . (u x).  u x is the same
    // operand for every warp: its NX bf16 terms are formed once, into the C
    // rows' space (no longer read in this chunk), then read with ldmatrix.
    {
      const int ldu = L.ldu, half = PW / 2;
      __nv_bfloat16* ux = reinterpret_cast<__nv_bfloat16*>(smem + L.c);
      for (int e = tid; e < qp * half; e += THREADS) {
        const int j = e / half, p = 2 * (e % half);
        float v0 = to_f32(xs[j * L.ldx + p]) * us[j], v1 = to_f32(xs[j * L.ldx + p + 1]) * us[j];
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          const __nv_bfloat162 hb = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(ux + ((size_t)k * qp + j) * ldu + p) = hb;
          v0 -= __low2float(hb);
          v1 -= __high2float(hb);
        }
      }
    }
    __syncthreads();
    if (owns_s) {
      const __nv_bfloat16* ux = reinterpret_cast<const __nv_bfloat16*>(smem + L.c);
      const float dl = expf(cum[Q - 1]);
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] *= dl;
      for (int j0 = 0; j0 < qp; j0 += 16) {
        uint32_t ba[NI][4];
        frag_a_mrow<NI>(ba, bs + j0 * L.ldc + s0, L.ldc, lane);
#pragma unroll
        for (int n = 0; n < NP; n += NT) {
          uint32_t xt[NX][NT][1][2], xb[NT][NX][2];
#pragma unroll
          for (int k = 0; k < NX; ++k)
            frag_b_krow<1, NT>(xt[k], ux + ((size_t)k * qp + j0) * L.ldu + 8 * n, L.ldu, lane);
#pragma unroll
          for (int m = 0; m < NT; ++m)
#pragma unroll
            for (int k = 0; k < NX; ++k) xb[m][k][0] = xt[k][m][0][0], xb[m][k][1] = xt[k][m][0][1];
#pragma unroll
          for (int m = 0; m < NT; ++m) mma_terms(st[n + m], ba, xb[m]);
        }
      }
      if (c + 1 < nc) store_state(hs, L.ldh, st, s0, lane);
    }
  }
  if (owns_s) {
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 8 * n + 2 * t + (e & 1), s = s0 + g + 8 * (e >> 1);
        if (s < ds) a.hout[(hbase + p) * ds + s] = st[n][e];
      }
  }
}

template <typename T, int PW>
cudaError_t launch_main(const Args& a, int B, int P, cudaStream_t s) {
  const size_t smem = smem_layout(a.Q, a.ds, PW, sizeof(T)).total;
  cudaError_t e = allow_smem(ssd_chunks<T, PW>, smem);
  if (e != cudaSuccess) return e;
  ssd_chunks<T, PW><<<dim3(P, a.H, B), THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Args& a, int B, int P, cudaStream_t s) {
  switch (a.hd / P) {
    case 8: return launch_main<T, 8>(a, B, P, s);
    case 16: return launch_main<T, 16>(a, B, P, s);
    case 32: return launch_main<T, 32>(a, B, P, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// xh (B,T,H,hd), Bc/Cc (B,T,1,ds) with the given batch and time strides (in
// elements; the inner dimensions packed), dt (B,T,H) f32 contiguous, A (H,)
// f32, h0 (B,H,hd,ds) f32 or null; outputs y (B,T,H,hd) and hout (B,H,hd,ds)
// f32, contiguous.  Each (head, lane) is split over `splits` CTAs of
// hd / splits in {8, 16, 32} columns.
DVI_EXPORT int dvi_ssd_scan(const void* xh, const void* Bc, const void* Cc, const void* dt,
                            const void* A, const void* h0, long long sxb, long long sxt,
                            long long sbb, long long sbt, long long scb, long long sct, int B,
                            int T, int H, int hd, int ds, int Q, int is_bf16, int splits,
                            void* y, void* hout, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || hd <= 0 || hd % 8 != 0 || hd > 128 || ds <= 0 ||
      ds % 8 != 0 || ds > MAX_DS || Q < 1 || Q > MAX_Q || T % Q != 0 || splits <= 0 ||
      hd % splits != 0)
    return cudaErrorInvalidValue;
  const Args a{xh, Bc, Cc, static_cast<const float*>(dt), static_cast<const float*>(A),
               static_cast<const float*>(h0), sxb, sxt, sbb, sbt, scb, sct, T, H, hd,
               ds, Q, static_cast<float*>(y), static_cast<float*>(hout)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(a, B, splits, s) : run<float>(a, B, splits, s);
}
