// paged_decode_attention: flash-decode GQA over a pooled, paged KV cache read
// through per-lane block tables, for a block of Tq >= 1 queries per lane.
//
// Replaces the Pallas kernel src/repro/kernels/paged_decode_attention.py
// (paged_decode_attention, pallas_call at :127).  There the block table,
// lengths and page counts ride in as scalar-prefetch operands so the grid's
// index map can DMA physical page tbl[b, p] for logical page p; the grid
// (B, KV, MPS) walks logical pages in a sequential axis, clamps pages past
// the lane's page count onto its last one and skips their update, and masks
// unmapped (-1, clamped onto null page 0) pages and slots past the length.
//
// Here the C CTAs of one thread block cluster own one (lane, kv head) and
// hold its Tq * G query rows (a row tile of up to 64 of them, the tiles of a
// prefill chunk side by side on the grid), as decode_attention.cu does.  They split the
// lane's first pc logical pages, slot by slot, between them (pc is the
// optional page_counts[b] clipped to [1, MPS], by default
// min(ceil(len/ps), MPS), the same page mask for every query of a block);
// each copies the table entries of its own share into shared memory (the
// counterpart of the scalar prefetch) and computes each slot's address
// from it: slot j of the lane is K/V row tbl[j / ps] * ps + j % ps of the
// pages viewed as (P * ps, KV, hd), whatever the page size (ps >= 1).  A
// slot on an unmapped page (-1, mid-row or a wholly unmapped row) copies
// nothing and is masked; the null page is never read.  Query t sees mapped
// slots j < min(lengths[b] - (Tq-1-t), MPS * ps), where lengths[b] counts the
// block's own writes: the reference's paged step mask (mapped, j < len + T,
// pos <= qpos).  A query with no live slot, as on an idle lane of length 0
// with an all -1 row, gets 0.  The body is attn_tile.cuh.
//
// The int8 KV cache (kv_int8: int8 pages with k_scale and v_scale (P, ps,
// KV) float32, the reference's paged layout under kv_quant): the body
// stages each slot's int8 row and its scales and dequantises the landed
// tile in shared memory (attn_tile.cuh), as decode_attention.cu does.
//
// Bound on H100: the live mapped K and V bytes of the call (at the verify
// pass of the continuous path, B = 8, 32 kv heads of 128 in bf16 and about
// 135 live slots a lane, some 18 MB: 0.0054 ms at 3.35 TB/s; 0.0051 ms at a
// draft feed); the table and q are small beside them.  The design is
// decode_attention.cu's: every copy in flight while earlier tiles are
// folded, each live mapped byte read once, a split over C CTAs only where
// pairs are too few (C = 1 on the continuous path).  Measured by
// chip_smoke.py phase 3 on an NVIDIA H100 80GB HBM3 at 700 W: 0.0201 ms at
// the verify pass and 0.0196 ms at a draft feed, device time that includes
// the timer's floor of about 0.005 ms; 12.8 us a launch on the continuous
// path's profile.
#include "attn_tile.cuh"

namespace {

// slot j of the lane lives on physical page tbl[j / ps - p0]: the share's
// table entries, from logical page p0 on, copied into shared memory by
// prepare(); nowhere when that entry is -1.  The lane visits its first
// pc pages: page_counts[b] clipped to [1, MPS], or ceil(len / ps) (at most
// MPS) without page counts; slots past them are never read.
struct PagedMap {
  const int* row_tbl;   // the lane's block-table row in device memory
  int* tbl;             // its share's entries in shared memory
  int p0, ps, mps;
  int pc;               // the lane's page count, or 0 for ceil(len / ps)
  __device__ int live(int len) const {
    return min(len, (pc > 0 ? pc : min((len + ps - 1) / ps, mps)) * ps);
  }
  __device__ void prepare(int lo, int hi) {
    p0 = lo / ps;
    const int np = hi > lo ? (hi - 1) / ps - p0 + 1 : 0;
    for (int i = threadIdx.x; i < np; i += attn::THREADS) tbl[i] = row_tbl[p0 + i];
  }
  __device__ long long row(int j) const {
    const int page = tbl[j / ps - p0];
    return page >= 0 ? (long long)page * ps + j % ps : -1;
  }
  __device__ int pos(int j) const { return j; }   // logical slot j holds position j
};

template <typename T, typename KT, int HD>
__global__ void __launch_bounds__(attn::THREADS)
paged_decode_attn(const T* __restrict__ q, const KT* __restrict__ kp, const KT* __restrict__ vp,
                  const float* __restrict__ ksc, const float* __restrict__ vsc,
                  const int* __restrict__ lengths, const int* __restrict__ tables,
                  const int* __restrict__ page_counts, T* __restrict__ out, attn::Args a,
                  int ps, int mps) {
  extern __shared__ __align__(16) unsigned char smem[];
  // blockIdx.y is (kv head, row tile), the tile minor
  const int R = a.Tq * (a.H / a.KV), tiles = attn::row_tiles(R);
  const int b = blockIdx.z;
  const attn::Layout L = attn::layout(attn::tile_rows(R), a.hd, sizeof(T), sizeof(KT), a.bs,
                                      a.stages, a.splits, 0);
  const int pc = page_counts ? min(max(page_counts[b], 1), mps) : 0;
  const PagedMap map{tables + (size_t)b * mps, reinterpret_cast<int*>(smem + L.extra), 0, ps,
                     mps, pc};
  attn::flash_decode<T, KT, HD>(q, kp, vp, ksc, vsc, lengths, out, a, map, b,
                                blockIdx.y / tiles, (blockIdx.y % tiles) * attn::MAX_ROWS,
                                smem);
}

template <typename T, typename KT>
cudaError_t run(const void* q, const void* kp, const void* vp, const float* ksc,
                const float* vsc, const int* lengths, const int* tables, const int* pcs,
                void* out, int B, attn::Args a, int ps, int mps, cudaStream_t s) {
  const size_t smem = attn::plan(a, mps * ps, sizeof(T), sizeof(KT), ps);
  if (smem == 0) return cudaErrorInvalidValue;
  const T* qp = static_cast<const T*>(q);
  const KT* k = static_cast<const KT*>(kp);
  const KT* v = static_cast<const KT*>(vp);
  T* op = static_cast<T*>(out);
  if (a.hd <= 64)
    return attn::launch<paged_decode_attn<T, KT, 64>>(a, B, smem, s, qp, k, v, ksc, vsc,
                                                      lengths, tables, pcs, op, a, ps, mps);
  if (a.hd <= 128)
    return attn::launch<paged_decode_attn<T, KT, 128>>(a, B, smem, s, qp, k, v, ksc, vsc,
                                                       lengths, tables, pcs, op, a, ps, mps);
  return attn::launch<paged_decode_attn<T, KT, 256>>(a, B, smem, s, qp, k, v, ksc, vsc,
                                                     lengths, tables, pcs, op, a, ps, mps);
}

template <typename T>
cudaError_t run_kv(const void* q, const void* kp, const void* vp, const float* ksc,
                   const float* vsc, int kv_int8, const int* lengths, const int* tables,
                   const int* pcs, void* out, int B, const attn::Args& a, int ps, int mps,
                   cudaStream_t s) {
  return kv_int8
             ? run<T, int8_t>(q, kp, vp, ksc, vsc, lengths, tables, pcs, out, B, a, ps, mps, s)
             : run<T, T>(q, kp, vp, nullptr, nullptr, lengths, tables, pcs, out, B, a, ps, mps,
                         s);
}

}  // namespace

// kv_int8: int8 pages with k_scale and v_scale (P, ps, KV) float32, else
// pages in the query's dtype and the scales null.
DVI_EXPORT int dvi_paged_decode_attention(const void* q, const void* k_pages,
                                          const void* v_pages, const void* lengths,
                                          const void* block_tables, void* out, int B, int Tq,
                                          int H, int KV, int hd, int ps, int mps, float scale,
                                          int splits, int is_bf16, const void* page_counts,
                                          const void* k_scale, const void* v_scale,
                                          int kv_int8, void* stream) {
  const attn::Args a{Tq, H, KV, hd, 0, 0, splits, scale};
  if (!attn::valid(a, B, is_bf16, kv_int8) || ps <= 0 || mps <= 0 ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const int* lp = static_cast<const int*>(lengths);
  const int* tp = static_cast<const int*>(block_tables);
  const int* pp = static_cast<const int*>(page_counts);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run_kv<__nv_bfloat16>(q, k_pages, v_pages, ks, vs, kv_int8, lp, tp, pp, out,
                                         B, a, ps, mps, s)
                 : run_kv<float>(q, k_pages, v_pages, ks, vs, kv_int8, lp, tp, pp, out, B, a,
                                 ps, mps, s);
}
