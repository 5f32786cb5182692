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
// The non-causal form (causal = 0) is a decoder's cross-attention over the
// encoder's K/V (transformer._cross_attn; the reference computes it as
// attend_full with every frame visible): every query of the block sees the
// slots j < lengths[b], lengths all F.  Only the per-row limit differs
// (attn_tile.cuh: qend = len), so it reads each live K/V row once for all
// Tq * G rows, as the causal form does.
//
// The ring form (pos != null) reads a sliding-window layer's ring of S = W +
// slack slots, position p at slot p % S (transformer.spread_write with
// wrap): pos (B, S) int32 holds each slot's position (-1: empty), and query
// t at qpos = lengths[b] - Tq + t sees slot j iff 0 <= pos[b, j] <= qpos
// and, with window > 0, pos[b, j] > qpos - window: the reference's ring step
// mask (transformer.py:343-345).  Positions fill slots in order until they
// wrap, so the slots to visit are still the first min(lengths[b], S): a
// third slot map (RingMap) beside the contiguous one.  Each CTA copies the
// positions of its share into shared memory once, before its K/V tiles
// (all copies in flight at once, as the paged map stages its table), and
// the tiles' slot positions are read from there.
//
// The int8 KV cache (kv_int8: k and v int8, k_scale and v_scale (B, S, KV)
// float32, one scale a slot and kv head), in the contiguous and the ring
// form: the reference stores K/V so (transformer.kv_quantize) and
// dequantises them in jnp before it attends; here the body stages the int8
// rows and their scales and dequantises each landed tile in shared memory
// (attn_tile.cuh), so a call reads hd + 4 bytes a slot and kv head for K
// (and again for V) instead of 2 hd.  The non-causal form rejects int8:
// cross K/V stay in the model dtype.
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
  __device__ int pos(int j) const { return j; }
};

// a ring: slot j of lane b is cache row b * S + j and holds position
// pos_row[j]; prepare() copies the share's positions into shared memory
// (spos[j - lo]) and waits for them (and for the query rows issued before)
struct RingMap {
  long long base;
  int cap;
  const int* pos_row;   // the lane's row of pos (B, S) in device memory
  int* spos;            // its share's positions in shared memory
  int lo;
  __device__ int live(int len) const { return min(len, cap); }
  __device__ void prepare(int lo_, int hi) {
    lo = lo_;
    for (int i = threadIdx.x; i < hi - lo; i += attn::THREADS)
      attn::cp_async4(spos + i, pos_row + lo + i);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __device__ long long row(int j) const { return base + j; }
  __device__ int pos(int j) const { return spos[j - lo]; }
};

template <typename T, typename KT, int HD, bool RING>
__global__ void __launch_bounds__(attn::THREADS)
decode_attn(const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
            const float* __restrict__ ksc, const float* __restrict__ vsc,
            const int* __restrict__ lengths, const int* __restrict__ pos, T* __restrict__ out,
            attn::Args a, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  // blockIdx.y is (kv head, row tile), the tile minor
  const int b = blockIdx.z, tiles = attn::row_tiles(a.Tq * (a.H / a.KV));
  const int kvh = blockIdx.y / tiles, r0 = (blockIdx.y % tiles) * attn::MAX_ROWS;
  if constexpr (RING) {
    const attn::Layout L = attn::layout(attn::tile_rows(a.Tq * (a.H / a.KV)), a.hd, sizeof(T),
                                        sizeof(KT), a.bs, a.stages, a.splits, 0);
    attn::flash_decode<T, KT, HD>(q, k, v, ksc, vsc, lengths, out, a,
                                  RingMap{(long long)b * S, S, pos + (size_t)b * S,
                                          reinterpret_cast<int*>(smem + L.extra), 0},
                                  b, kvh, r0, smem);
  } else {
    attn::flash_decode<T, KT, HD>(q, k, v, ksc, vsc, lengths, out, a,
                                  ContigMap{(long long)b * S, S}, b, kvh, r0, smem);
  }
}

template <typename T, typename KT, int HD>
cudaError_t launch_hd(const T* q, const KT* k, const KT* v, const float* ksc, const float* vsc,
                      const int* lengths, const int* pos, T* out, int B, const attn::Args& a,
                      int S, size_t smem, cudaStream_t s) {
  if (pos != nullptr)
    return attn::launch<decode_attn<T, KT, HD, true>>(a, B, smem, s, q, k, v, ksc, vsc, lengths,
                                                      pos, out, a, S);
  return attn::launch<decode_attn<T, KT, HD, false>>(a, B, smem, s, q, k, v, ksc, vsc, lengths,
                                                     pos, out, a, S);
}

template <typename T, typename KT>
cudaError_t run(const void* q, const void* k, const void* v, const float* ksc, const float* vsc,
                const int* lengths, const int* pos, void* out, int B, attn::Args a, int S,
                cudaStream_t s) {
  const size_t smem = attn::plan(a, S, sizeof(T), sizeof(KT), 0, pos != nullptr);
  if (smem == 0) return cudaErrorInvalidValue;
  const T* qp = static_cast<const T*>(q);
  const KT* kp = static_cast<const KT*>(k);
  const KT* vp = static_cast<const KT*>(v);
  T* op = static_cast<T*>(out);
  if (a.hd <= 64)
    return launch_hd<T, KT, 64>(qp, kp, vp, ksc, vsc, lengths, pos, op, B, a, S, smem, s);
  if (a.hd <= 128)
    return launch_hd<T, KT, 128>(qp, kp, vp, ksc, vsc, lengths, pos, op, B, a, S, smem, s);
  return launch_hd<T, KT, 256>(qp, kp, vp, ksc, vsc, lengths, pos, op, B, a, S, smem, s);
}

template <typename T>
cudaError_t run_kv(const void* q, const void* k, const void* v, const float* ksc,
                   const float* vsc, int kv_int8, const int* lengths, const int* pos, void* out,
                   int B, const attn::Args& a, int S, cudaStream_t s) {
  return kv_int8 ? run<T, int8_t>(q, k, v, ksc, vsc, lengths, pos, out, B, a, S, s)
                 : run<T, T>(q, k, v, nullptr, nullptr, lengths, pos, out, B, a, S, s);
}

}  // namespace

// pos: null for a full cache, else the ring's (B, S) int32 positions;
// window: 0, or the sliding window of the ring form; causal: 0 for the
// non-causal form (every query sees j < lengths[b]), which the ring form
// rejects; kv_int8: k and v int8 with k_scale and v_scale (B, S, KV)
// float32 (the causal and the ring form), else in the query's dtype and
// the scales null.
DVI_EXPORT int dvi_decode_attention(const void* q, const void* k, const void* v,
                                    const void* lengths, void* out, int B, int Tq, int H,
                                    int KV, int hd, int S, float scale, int splits,
                                    int is_bf16, const void* pos, int window, int causal,
                                    const void* k_scale, const void* v_scale, int kv_int8,
                                    void* stream) {
  const attn::Args a{Tq, H, KV, hd, 0, 0, splits, scale, window, causal != 0};
  if (!attn::valid(a, B, is_bf16, kv_int8) || S <= 0 || window < 0 ||
      (window > 0 && pos == nullptr) || (causal == 0 && pos != nullptr) ||
      (kv_int8 && (causal == 0 || k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const int* lp = static_cast<const int*>(lengths);
  const int* pp = static_cast<const int*>(pos);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run_kv<__nv_bfloat16>(q, k, v, ks, vs, kv_int8, lp, pp, out, B, a, S, s)
                 : run_kv<float>(q, k, v, ks, vs, kv_int8, lp, pp, out, B, a, S, s);
}
