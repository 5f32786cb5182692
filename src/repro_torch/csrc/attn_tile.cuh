// The flash-decode body shared by the two attention kernels
// (decode_attention.cu over a contiguous cache, paged_decode_attention.cu
// over pooled pages).  They differ only in where slot j of a lane lives;
// everything else is here: the shared-memory layout, the query load, the
// staging of one tile of K/V rows, the tile's scores, the float32 online
// softmax update, P.V, and the final store.
//
// One CUDA block owns one (lane b, kv head): its R = Tq * G query rows are
// the G query heads sharing the kv head times the Tq queries of the block,
// so each K/V tile is read from device memory once for all of them.  Row r
// is query t = r / G, head kvh * G + r % G.  Query t sees slot j when the
// slot is present (its K/V row was staged) and j < min(len - (Tq-1-t), cap),
// where len counts the block's own writes and cap is the lane's capacity.
// A query with no visible slot is written as 0.
//
// Tiles are BS = 32 slots, one per lane of a warp; loads are four elements
// a thread, synchronous; products are CUDA-core FMAs from shared memory.
#pragma once

#include "common.cuh"

namespace attn {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int BS = 32;  // slots per tile == warp size

struct Smem {
  float* qs;    // R x hp, q * scale
  float* ks;    // BS x hp
  float* vs;    // BS x hd
  float* ps;    // R x BS scores, then probabilities
  float* acc;   // R x hd
  float* mrow;  // R running max
  float* lrow;  // R running sum
  float* arow;  // R rescale of this tile
  int hp;       // padded row stride: conflict-free dots
};

__host__ __device__ inline size_t smem_floats(int R, int hd) {
  return (size_t)R * (hd + 1) + (size_t)BS * (hd + 1) + (size_t)BS * hd + (size_t)R * BS +
         (size_t)R * hd + 3 * (size_t)R;
}

__device__ __forceinline__ Smem carve(float* smem, int R, int hd) {
  Smem s;
  s.hp = hd + 1;
  s.qs = smem;
  s.ks = s.qs + R * s.hp;
  s.vs = s.ks + BS * s.hp;
  s.ps = s.vs + BS * hd;
  s.acc = s.ps + R * BS;
  s.mrow = s.acc + R * hd;
  s.lrow = s.mrow + R;
  s.arow = s.lrow + R;
  return s;
}

// q (B, Tq, H, hd): load lane b's rows for kv head kvh, scaled; zero the
// accumulator and the running sums.  Ends with __syncthreads().
template <typename T>
__device__ void load_queries(const Smem& s, const T* __restrict__ q, int b, int kvh, int Tq,
                             int H, int G, int hd, float scale) {
  const int R = Tq * G;
  for (int i = threadIdx.x; i < R * hd; i += THREADS) {
    const int r = i / hd, dd = i % hd, t = r / G, g = r % G;
    s.qs[r * s.hp + dd] = to_f32(q[(((size_t)b * Tq + t) * H + kvh * G + g) * hd + dd]) * scale;
    s.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += THREADS) {
    s.mrow[r] = -1e30f;
    s.lrow[r] = 0.f;
  }
  __syncthreads();
}

// Stage one tile: tile slot j takes K/V row rows[j] of k/v viewed as
// (rows, KV, hd); rows[j] < 0 stages zeros and loads nothing.  The caller
// synchronises before and after.
template <typename T>
__device__ void stage_tile(const Smem& s, const T* __restrict__ k, const T* __restrict__ v,
                           const long long* rows, int KV, int kvh, int hd) {
  const int q4 = hd / 4;
  for (int i = threadIdx.x; i < BS * q4; i += THREADS) {
    const int j = i / q4, d4 = (i % q4) * 4;
    float kk[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
    const long long row = rows[j];
    if (row >= 0) {
      const size_t off = ((size_t)row * KV + kvh) * hd + d4;
      load4(k + off, kk);
      load4(v + off, vv);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s.ks[j * s.hp + d4 + c] = kk[c];
      s.vs[j * hd + d4 + c] = vv[c];
    }
  }
}

// Fold the staged tile, slots s0 .. s0+BS-1, into the online softmax of
// every row.  rows[j] < 0 marks a slot that is not there.
__device__ inline void fold_tile(const Smem& s, const long long* rows, int s0, int len, int cap,
                          int Tq, int G, int hd) {
  const int R = Tq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // scores: a warp takes one row, its lanes the 32 slots of the tile
  for (int p = tid; p < R * BS; p += THREADS) {
    const int r = p / BS, j = p % BS;
    const int lim = min(len - (Tq - 1 - r / G), cap);
    float sc = 0.f;
    if (rows[j] >= 0 && s0 + j < lim) {
      const float* qr = s.qs + r * s.hp;
      const float* kr = s.ks + j * s.hp;
      for (int dd = 0; dd < hd; ++dd) sc = fmaf(qr[dd], kr[dd], sc);
    }
    s.ps[p] = sc;
  }
  __syncthreads();

  // online softmax update, one warp per row, lane == slot
  for (int r = warp; r < R; r += NW) {
    const int lim = min(len - (Tq - 1 - r / G), cap);
    const bool ok = rows[lane] >= 0 && s0 + lane < lim;
    const float sc = s.ps[r * BS + lane];
    float tmax = ok ? sc : -1e30f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_old = s.mrow[r];
    const float m_new = fmaxf(m_old, tmax);
    const float p = ok ? expf(sc - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    s.ps[r * BS + lane] = p;
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      s.lrow[r] = s.lrow[r] * alpha + psum;
      s.mrow[r] = m_new;
      s.arow[r] = alpha;
    }
  }
  __syncthreads();

  // acc = acc * alpha + p @ V_tile (absent slots carry p = 0)
  for (int i = tid; i < R * hd; i += THREADS) {
    const int r = i / hd, dd = i % hd;
    const float* pr = s.ps + r * BS;
    float a = s.acc[i] * s.arow[r];
    for (int j = 0; j < BS; ++j) a = fmaf(pr[j], s.vs[j * hd + dd], a);
    s.acc[i] = a;
  }
  __syncthreads();
}

// out (B, Tq, H, hd) in the query dtype: acc / l, 0 for a row that saw no slot.
template <typename T>
__device__ void store_out(const Smem& s, T* __restrict__ out, int b, int kvh, int Tq, int H,
                          int G, int hd) {
  const int R = Tq * G;
  for (int i = threadIdx.x; i < R * hd; i += THREADS) {
    const int r = i / hd, dd = i % hd, t = r / G, g = r % G;
    out[(((size_t)b * Tq + t) * H + kvh * G + g) * hd + dd] =
        from_f32<T>(s.acc[i] / fmaxf(s.lrow[r], 1e-30f));
  }
}

}  // namespace attn
