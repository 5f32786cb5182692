// decode_attention: flash-decode GQA over a contiguous KV cache, for a block
// of Tq >= 1 queries per lane.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py
// (decode_attention_pallas, pallas_call at :83), whose grid walks every
// sequence block of the cache in a sequential axis, masking slots past the
// lane's length, with an online softmax carried in VMEM scratch.  Here the C
// CTAs of one thread block cluster own one (lane, kv head) and split the
// lane's live slots between them, read from its length on the card, so
// rejected speculative writes and the unused capacity past the length are
// never read; the G query heads that share the kv head and the Tq queries of
// the block ride in the same CTA (Tq * G rows, up to 64), so each K/V row is
// read from device memory once for all of them.  A chunk of prefill queries
// (Tq * G > 64, Tq up to 128) is cut into row tiles of 64, one CTA (or
// cluster) each, still in one launch.  The body (cp.async ring, tensor-core
// products for bf16, per-warp online softmax, merge across the cluster in
// distributed shared memory) is attn_tile.cuh, shared with
// paged_decode_attention.cu; only the slot -> cache row map is here.
//
// Masking: query t of the block sees slots j < lengths[b] - (Tq-1-t) (and
// j < S), where lengths[b] counts the block's own writes.  On a contiguous
// full cache this is the reference's step mask pos <= qpos.  A query with no
// live slot gets 0 (the model path never has one).
//
// Bound on H100: the live K and V bytes of the call (16 MB at the verify
// pass of the sync path, B = 8, about 120 live slots a lane, 32 heads of 128
// in bf16: 0.0049 ms at 3.35 TB/s; 0.0045 ms at a draft feed).  The design
// keeps every byte's copy in flight while earlier tiles are folded, reads
// each live byte once for all Tq * G rows and no byte past the length, and
// splits a lane over C CTAs only where (lane, kv head) pairs are too few to
// fill the card (ops.attn_splits: C = 1 on the vicuna paths).  Measured by
// chip_smoke.py phase 3 on an NVIDIA H100 80GB HBM3 at 700 W: 0.0187 ms at
// the verify pass and 0.0181 ms at a draft feed, device time that includes
// the timer's floor of about 0.005 ms; 13.4 us a launch on the sync path's
// profile.
#include "attn_tile.cuh"

namespace {

// slot j of lane b is cache row b * S + j
struct ContigMap {
  long long base;
  int cap;
  __device__ int live(int len) const { return min(len, cap); }
  __device__ void prepare(int, int) {}
  __device__ long long row(int j) const { return base + j; }
};

template <typename T, int HD>
__global__ void __launch_bounds__(attn::THREADS)
decode_attn(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ lengths, T* __restrict__ out, attn::Args a, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  // blockIdx.y is (kv head, row tile), the tile minor
  const int b = blockIdx.z, tiles = attn::row_tiles(a.Tq * (a.H / a.KV));
  attn::flash_decode<T, HD>(q, k, v, lengths, out, a, ContigMap{(long long)b * S, S}, b,
                            blockIdx.y / tiles, (blockIdx.y % tiles) * attn::MAX_ROWS, smem);
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const int* lengths, void* out,
                int B, attn::Args a, int S, cudaStream_t s) {
  const size_t smem = attn::plan(a, S, sizeof(T), 0);
  if (smem == 0) return cudaErrorInvalidValue;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (a.hd <= 64)
    return attn::launch<decode_attn<T, 64>>(a, B, smem, s, qp, kp, vp, lengths, op, a, S);
  if (a.hd <= 128)
    return attn::launch<decode_attn<T, 128>>(a, B, smem, s, qp, kp, vp, lengths, op, a, S);
  return attn::launch<decode_attn<T, 256>>(a, B, smem, s, qp, kp, vp, lengths, op, a, S);
}

}  // namespace

DVI_EXPORT int dvi_decode_attention(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int B, int Tq, int H,
                                    int KV, int hd, int S, float scale, int splits,
                                    int is_bf16, void* stream) {
  const attn::Args a{Tq, H, KV, hd, 0, 0, splits, scale};
  if (!attn::valid(a, B, is_bf16) || S <= 0) return cudaErrorInvalidValue;
  const int* lp = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(q, k, v, lp, out, B, a, S, s)
                 : run<float>(q, k, v, lp, out, B, a, S, s);
}
