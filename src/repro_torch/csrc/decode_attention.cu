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
// CUDA-core FMAs from shared memory.  The tile body is attn_tile.cuh, shared
// with paged_decode_attention.cu; only the slot -> cache row map is here.
#include "attn_tile.cuh"

namespace {

using attn::BS;
using attn::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ lengths, T* __restrict__ out, int Tq, int H, int KV,
            int hd, int S, float scale) {
  extern __shared__ float smem[];
  __shared__ long long rows[BS];     // cache row (b * S + slot) of each tile slot
  const int G = H / KV, R = Tq * G;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const attn::Smem s = attn::carve(smem, R, hd);
  const int len = lengths[b];
  const int n_live = min(len, S);
  attn::load_queries(s, q, b, kvh, Tq, H, G, hd, scale);

  for (int s0 = 0; s0 < n_live; s0 += BS) {
    if (threadIdx.x < BS) {
      const int j = s0 + threadIdx.x;
      rows[threadIdx.x] = j < n_live ? (long long)b * S + j : -1;
    }
    __syncthreads();
    attn::stage_tile(s, k, v, rows, KV, kvh, hd);
    __syncthreads();
    attn::fold_tile(s, rows, s0, len, S, Tq, G, hd);
  }
  attn::store_out(s, out, b, kvh, Tq, H, G, hd);
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const int* lengths, void* out,
                int B, int Tq, int H, int KV, int hd, int S, float scale, cudaStream_t s) {
  const size_t smem = attn::smem_floats(Tq * (H / KV), hd) * sizeof(float);
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
