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
  int p0, ps, mps, cap;
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
};

template <typename T, int HD>
__global__ void __launch_bounds__(attn::THREADS)
paged_decode_attn(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                  const int* __restrict__ lengths, const int* __restrict__ tables,
                  const int* __restrict__ page_counts, T* __restrict__ out, attn::Args a,
                  int ps, int mps) {
  extern __shared__ __align__(16) unsigned char smem[];
  // blockIdx.y is (kv head, row tile), the tile minor
  const int R = a.Tq * (a.H / a.KV), tiles = attn::row_tiles(R);
  const int b = blockIdx.z;
  const attn::Layout L =
      attn::layout(attn::tile_rows(R), a.hd, sizeof(T), a.bs, a.stages, a.splits, 0);
  const int pc = page_counts ? min(max(page_counts[b], 1), mps) : 0;
  const PagedMap map{tables + (size_t)b * mps, reinterpret_cast<int*>(smem + L.extra), 0, ps,
                     mps, mps * ps, pc};
  attn::flash_decode<T, HD>(q, kp, vp, lengths, out, a, map, b, blockIdx.y / tiles,
                            (blockIdx.y % tiles) * attn::MAX_ROWS, smem);
}

template <typename T>
cudaError_t run(const void* q, const void* kp, const void* vp, const int* lengths,
                const int* tables, const int* pcs, void* out, int B, attn::Args a, int ps,
                int mps, cudaStream_t s) {
  const size_t smem = attn::plan(a, mps * ps, sizeof(T), ps);
  if (smem == 0) return cudaErrorInvalidValue;
  const T* qp = static_cast<const T*>(q);
  const T* k = static_cast<const T*>(kp);
  const T* v = static_cast<const T*>(vp);
  T* op = static_cast<T*>(out);
  if (a.hd <= 64)
    return attn::launch<paged_decode_attn<T, 64>>(a, B, smem, s, qp, k, v, lengths, tables,
                                                  pcs, op, a, ps, mps);
  if (a.hd <= 128)
    return attn::launch<paged_decode_attn<T, 128>>(a, B, smem, s, qp, k, v, lengths, tables,
                                                   pcs, op, a, ps, mps);
  return attn::launch<paged_decode_attn<T, 256>>(a, B, smem, s, qp, k, v, lengths, tables,
                                                 pcs, op, a, ps, mps);
}

}  // namespace

DVI_EXPORT int dvi_paged_decode_attention(const void* q, const void* k_pages,
                                          const void* v_pages, const void* lengths,
                                          const void* block_tables, void* out, int B, int Tq,
                                          int H, int KV, int hd, int ps, int mps, float scale,
                                          int splits, int is_bf16, const void* page_counts,
                                          void* stream) {
  const attn::Args a{Tq, H, KV, hd, 0, 0, splits, scale};
  if (!attn::valid(a, B, is_bf16) || ps <= 0 || mps <= 0) return cudaErrorInvalidValue;
  const int* lp = static_cast<const int*>(lengths);
  const int* tp = static_cast<const int*>(block_tables);
  const int* pp = static_cast<const int*>(page_counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(q, k_pages, v_pages, lp, tp, pp, out, B, a, ps, mps, s)
                 : run<float>(q, k_pages, v_pages, lp, tp, pp, out, B, a, ps, mps, s);
}
