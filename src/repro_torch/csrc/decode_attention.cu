// decode_attention: flash-decode GQA over a contiguous KV cache, for a block
// of Tq >= 1 queries per lane.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py
// (decode_attention_pallas, pallas_call at :83), whose grid walks every
// sequence block of the cache in a sequential axis, masking slots past the
// lane's length, with an online softmax carried in VMEM scratch.  Here one
// block owns one (lane, kv head): it reads the lane's length and visits only
// its live slots, in tiles of 32, so rejected speculative writes and the
// unused capacity past the length are never read.  The G query heads that
// share the kv head, and the Tq queries of the block, ride in the same block
// (Tq * G rows), so each K/V tile is read from device memory once for all of
// them.  Scores, the running max and sum, and the output accumulator stay in
// float32 in shared memory; the output is written once, in the query dtype.
//
// Masking: query t of the block sees slots j < lengths[b] - (Tq-1-t) (and
// j < S), where lengths[b] counts the block's own writes.  On a contiguous
// full cache this is the reference's step mask pos <= qpos.  A query with no
// live slot gets 0 (the model path never has one).
//
// Bound on H100: the live K and V bytes of the call (26 MB at B = 8, 200 live
// slots, 32 heads of 128 in bf16, about 8 us at 3.35 TB/s).  This first
// version stages tiles synchronously (no cp.async/TMA pipelining) and uses
// CUDA-core FMAs from shared memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int BS = 32;               // slots per tile == warp size

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ lengths, T* __restrict__ out, int Tq, int H, int KV,
            int hd, int S, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV, R = Tq * G;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hp = hd + 1;             // padded row stride: conflict-free dots
  float* qs = smem;                  // R x hp, q * scale
  float* ks = qs + R * hp;           // BS x hp
  float* vs = ks + BS * hp;          // BS x hd
  float* ps = vs + BS * hd;          // R x BS scores, then probabilities
  float* acc = ps + R * BS;          // R x hd
  float* mrow = acc + R * hd;        // R running max
  float* lrow = mrow + R;            // R running sum
  float* arow = lrow + R;            // R rescale of this tile

  const int len = lengths[b];
  const int n_live = min(len, S);
  for (int i = tid; i < R * hd; i += THREADS) {
    const int r = i / hd, dd = i % hd, t = r / G, g = r % G;
    qs[r * hp + dd] = to_f32(q[(((size_t)b * Tq + t) * H + kvh * G + g) * hd + dd]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    mrow[r] = -1e30f;
    lrow[r] = 0.f;
  }
  __syncthreads();

  const int q4 = hd / 4;
  for (int s0 = 0; s0 < n_live; s0 += BS) {
    const int nt = min(BS, n_live - s0);
    for (int i = tid; i < BS * q4; i += THREADS) {
      const int j = i / q4, d4 = (i % q4) * 4;
      float kk[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nt) {
        const size_t off = (((size_t)b * S + s0 + j) * KV + kvh) * hd + d4;
        load4(k + off, kk);
        load4(v + off, vv);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ks[j * hp + d4 + c] = kk[c];
        vs[j * hd + d4 + c] = vv[c];
      }
    }
    __syncthreads();

    // scores: a warp takes one row, its lanes the 32 slots of the tile
    for (int p = tid; p < R * BS; p += THREADS) {
      const int r = p / BS, j = p % BS;
      const int lim = min(len - (Tq - 1 - r / G), S);
      float s = 0.f;
      if (j < nt && s0 + j < lim) {
        const float* qr = qs + r * hp;
        const float* kr = ks + j * hp;
        for (int dd = 0; dd < hd; ++dd) s = fmaf(qr[dd], kr[dd], s);
      }
      ps[p] = s;
    }
    __syncthreads();

    // online softmax update, one warp per row, lane == slot
    for (int r = warp; r < R; r += NW) {
      const int lim = min(len - (Tq - 1 - r / G), S);
      const bool ok = lane < nt && s0 + lane < lim;
      const float s = ps[r * BS + lane];
      float tmax = ok ? s : -1e30f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, tmax);
      const float p = ok ? expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      ps[r * BS + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        lrow[r] = lrow[r] * alpha + psum;
        mrow[r] = m_new;
        arow[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V_tile
    for (int i = tid; i < R * hd; i += THREADS) {
      const int r = i / hd, dd = i % hd;
      const float* pr = ps + r * BS;
      float a = acc[i] * arow[r];
      for (int j = 0; j < nt; ++j) a = fmaf(pr[j], vs[j * hd + dd], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * hd; i += THREADS) {
    const int r = i / hd, dd = i % hd, t = r / G, g = r % G;
    out[(((size_t)b * Tq + t) * H + kvh * G + g) * hd + dd] =
        from_f32<T>(acc[i] / fmaxf(lrow[r], 1e-30f));
  }
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const int* lengths, void* out,
                int B, int Tq, int H, int KV, int hd, int S, float scale, cudaStream_t s) {
  const int R = Tq * (H / KV);
  const size_t floats = (size_t)R * (hd + 1) + (size_t)BS * (hd + 1) + (size_t)BS * hd +
                        (size_t)R * BS + (size_t)R * hd + 3 * (size_t)R;
  const size_t smem = floats * sizeof(float);
  cudaError_t e = allow_smem(decode_attn<T>, smem);
  if (e != cudaSuccess) return e;
  decode_attn<T><<<dim3(B, KV), THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), Tq, H, KV, hd, S, scale);
  return cudaGetLastError();
}

}  // namespace

DVI_EXPORT int dvi_decode_attention(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int B, int Tq, int H,
                                    int KV, int hd, int S, float scale, int is_bf16,
                                    void* stream) {
  if (B <= 0 || Tq <= 0 || KV <= 0 || H % KV != 0 || hd % 4 != 0 || S <= 0)
    return cudaErrorInvalidValue;
  const int* lp = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(q, k, v, lp, out, B, Tq, H, KV, hd, S, scale, s)
                 : run<float>(q, k, v, lp, out, B, Tq, H, KV, hd, S, scale, s);
}
