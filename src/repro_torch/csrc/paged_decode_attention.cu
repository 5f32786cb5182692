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
// Here one CUDA block owns one (lane, kv head) and holds all Tq * G query
// rows, as decode_attention.cu does.  It copies the live part of its own
// block-table row into shared memory (the counterpart of the scalar
// prefetch) and walks only the lane's first min(ceil(len/ps), MPS) logical
// pages, in tiles of 32 logical slots, whatever the page size (ps >= 1).
// Slot j of the lane is K/V row tbl[j / ps] * ps + j % ps of the pages viewed
// as (P * ps, KV, hd).  A slot on an unmapped page (-1, mid-row or a wholly
// unmapped row) loads nothing and is masked, and a tile with no mapped slot
// is skipped; the null page is never read.  Query t sees mapped slots
// j < min(lengths[b] - (Tq-1-t), MPS * ps), where lengths[b] counts the
// block's own writes: the reference's paged step mask (mapped, j < len + T,
// pos <= qpos).  The online softmax stays in float32 (attn_tile.cuh, shared
// with decode_attention.cu); a query with no live slot, as on an idle lane of
// length 0 with an all -1 row, gets 0.
//
// Bound on H100: the live mapped K and V bytes of the call (at B = 8, 32 kv
// heads of 128 in bf16 and about 150 live slots a lane, some 20 MB, about
// 6 us at 3.35 TB/s); the table row and q are small beside them.  The design
// reads each live mapped K/V byte once for all Tq * G rows that need it and
// no byte past the lane's length, so it moves what the bound counts; this
// first version stages tiles synchronously (no cp.async/TMA pipelining) and
// uses CUDA-core FMAs, which is where it stands off that bound.
#include "attn_tile.cuh"

namespace {

using attn::BS;
using attn::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_attn(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                  const int* __restrict__ lengths, const int* __restrict__ tables,
                  T* __restrict__ out, int Tq, int H, int KV, int hd, int ps, int mps,
                  float scale) {
  extern __shared__ float smem[];
  __shared__ long long rows[BS];     // K/V row of each tile slot, -1 = absent
  const int G = H / KV, R = Tq * G;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const attn::Smem s = attn::carve(smem, R, hd);
  int* tbl = reinterpret_cast<int*>(smem + attn::smem_floats(R, hd));

  const int len = max(lengths[b], 0);
  const int pages = min((len + ps - 1) / ps, mps);
  const int n_live = min(len, pages * ps);
  for (int p = threadIdx.x; p < pages; p += THREADS) tbl[p] = tables[(size_t)b * mps + p];
  attn::load_queries(s, q, b, kvh, Tq, H, G, hd, scale);   // syncs

  for (int s0 = 0; s0 < n_live; s0 += BS) {
    int mapped = 0;
    if (threadIdx.x < BS) {
      const int j = s0 + threadIdx.x;
      long long row = -1;
      if (j < n_live) {
        const int page = tbl[j / ps];
        if (page >= 0) row = (long long)page * ps + j % ps;
      }
      rows[threadIdx.x] = row;
      mapped = row >= 0;
    }
    if (!__syncthreads_or(mapped)) continue;   // no mapped slot: nothing to read
    attn::stage_tile(s, kp, vp, rows, KV, kvh, hd);
    __syncthreads();
    attn::fold_tile(s, rows, s0, len, mps * ps, Tq, G, hd);
  }
  attn::store_out(s, out, b, kvh, Tq, H, G, hd);
}

template <typename T>
cudaError_t run(const void* q, const void* kp, const void* vp, const int* lengths,
                const int* tables, void* out, int B, int Tq, int H, int KV, int hd, int ps,
                int mps, float scale, cudaStream_t s) {
  const size_t smem = attn::smem_floats(Tq * (H / KV), hd) * sizeof(float) +
                      (size_t)mps * sizeof(int);
  cudaError_t e = allow_smem(paged_decode_attn<T>, smem);
  if (e != cudaSuccess) return e;
  paged_decode_attn<T><<<dim3(B, KV), THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), lengths,
      tables, static_cast<T*>(out), Tq, H, KV, hd, ps, mps, scale);
  return cudaGetLastError();
}

}  // namespace

DVI_EXPORT int dvi_paged_decode_attention(const void* q, const void* k_pages,
                                          const void* v_pages, const void* lengths,
                                          const void* block_tables, void* out, int B, int Tq,
                                          int H, int KV, int hd, int ps, int mps, float scale,
                                          int is_bf16, void* stream) {
  if (B <= 0 || Tq <= 0 || KV <= 0 || H % KV != 0 || hd % 4 != 0 || ps <= 0 || mps <= 0)
    return cudaErrorInvalidValue;
  const int* lp = static_cast<const int*>(lengths);
  const int* tp = static_cast<const int*>(block_tables);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? run<__nv_bfloat16>(q, k_pages, v_pages, lp, tp, out, B, Tq, H, KV, hd, ps, mps,
                                  scale, s)
             : run<float>(q, k_pages, v_pages, lp, tp, out, B, Tq, H, KV, hd, ps, mps, scale, s);
}
