// The flash-decode body shared by the two attention kernels
// (decode_attention.cu over a contiguous cache, paged_decode_attention.cu
// over pooled pages).  They differ only in where slot j of a lane lives (a
// Map: j -> K/V row, or -1 for an unmapped slot) and which position it
// holds (j itself, or a ring's pos[b, j]); everything else is here.
//
// Work split.  The R = Tq * G query rows of a kv head (row r is query
// t = r / G, head kvh * G + r % G) are cut into row tiles of up to MAX_ROWS
// (`tile_rows`), and the grid is (C, KV * row tiles, B) with clusters of
// (C, 1, 1): the C CTAs of one cluster own one (lane b, kv head, row tile)
// and each takes a contiguous share of the lane's live slots, computed on
// the card from lengths[b] (`share_slots`).  A CTA holds the rows of its
// tile, padded to MT = ceil(tile rows / 16) m16 tiles, so each K/V row is
// read from device memory once for every row of the tile that needs it: a
// decode block (Tq * G <= 64) is one tile, a chunk of prefill queries
// (Tq up to MAX_TQ) reads the lane's K/V once a tile.
// Its four warps split the m tiles and the share's 16-slot sub-tiles: warp w
// takes m tile w % MT and every (NW / MT)-th sub-tile of each tile.  Each warp
// keeps its own online softmax (running max m, sum l, output accumulator) in
// registers.  The warps merge in shared memory, then the CTAs of the cluster
// merge through distributed shared memory: each rank reads every rank's
// partial for its own slice of the output, rescales, sums and writes that
// slice once, in the query dtype; a lone CTA (C = 1) writes straight from
// its warps' merge.  One launch per call; a CTA with an empty share
// contributes m = -1e30 and l = 0.
//
// Loads.  The query rows go first, with 16-byte cp.async.cg copies that need
// no length.  Tiles of `bs` slots (a multiple of 16) go through a ring of up
// to three stages in shared memory, copied in their own dtype with the same
// copies, so the next tiles stream in while this one is folded.  A slot
// that is past the share or unmapped copies nothing (zero fill) and is
// masked.  Rows are padded by 16 bytes, so ldmatrix and the float32 reads
// are free of bank conflicts.
//
// The int8 KV cache (KT = int8_t, the storage type apart from the query's
// T): the ring stages int8 rows (hd bytes, hd / 16 copies a row) and, beside
// each staged slot's position, its K and V scale for this CTA's kv head
// (4-byte cp.async copies, zero filled with the rows).  Once a stage has
// landed, the CTA dequantises it into one K and one V tile of T in shared
// memory, each value (float)q * scale rounded once to T (the plain
// kv_dequantize), and the products below read that tile unchanged.  One
// tile pair, not one a stage: the ring's next copies still fly while the
// tile is folded.
//
// Products.  bf16: QK^T and P.V on tensor cores, mma.sync m16n8k16 with f32
// accumulation, fed by ldmatrix (.trans for V); the probabilities enter P.V
// rounded to bf16, as the plain version rounds them.  float32: CUDA-core
// FMAs from shared memory into the same register layout, so the softmax,
// the merges and the store are one code for both types.
//
// Masking.  Slot j holds position map.pos(j) (j on a full cache, pos[b, j]
// on a ring, -1 for an empty or unmapped slot).  Query t, at qpos = len - Tq
// + t where len counts the block's own writes, sees the slot when
// 0 <= pos <= qpos and, with a window W > 0, pos > qpos - W; padded rows see
// nothing.  On a full cache that is j < len - (Tq-1-t).  A non-causal call
// (Args::causal false: cross-attention over an encoder's K/V) lets every
// query of the block see j < len.  A query with no
// visible slot is written as 0.  Scores are scaled into base 2 and the
// softmax runs in float32.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace attn {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int SUB = 16;            // slots of a warp's sub-tile (mma n and k)
constexpr int MAX_ROWS = 64;       // query rows a CTA holds (a row tile): 4 m16 tiles
constexpr int MAX_TQ = 128;        // queries of a call: a prefill chunk's bound
constexpr int MAX_SPLITS = 8;      // largest portable cluster
constexpr int MAX_SMEM = 227 * 1024;  // dynamic shared memory a CTA may take
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The slots of each CTA's share of a lane with n_live live slots: whole
// sub-tiles split evenly; CTA `rank` takes [rank * share, (rank + 1) *
// share) clipped to n_live, empty past it.  ops.attn_share is the host's
// copy of this rule.
__host__ __device__ inline int share_slots(int n_live, int splits) {
  const int tiles = (n_live + SUB - 1) / SUB;
  return SUB * ((tiles + splits - 1) / splits);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// The rows of every row tile (the last one padded) and the number of tiles
// of a call with R = Tq * G query rows a kv head.
__host__ __device__ inline int tile_rows(int R) { return R < MAX_ROWS ? R : MAX_ROWS; }
__host__ __device__ inline int row_tiles(int R) { return (R + MAX_ROWS - 1) / MAX_ROWS; }

// The dynamic shared memory of one CTA, in byte offsets: the ring of K/V
// rows in their storage type (`ksize` bytes an element), the dequantised
// tile pair when that is not the query's (`tsize`), the query rows, the
// staged slots' positions and (int8) scales, the merge's rows.  The warps'
// partials reuse the ring and the tile once the last tile is folded.
struct Layout {
  size_t ring, tile, q, ok, sc, cm, cl, wts, extra, total;
};

__host__ __device__ inline Layout layout(int R, int hd, int tsize, int ksize, int bs,
                                         int stages, int splits, size_t extra_bytes) {
  const int mt = (R + 15) / 16, groups = NW / mt, rp = mt * 16;
  const int ld = hd + 16 / tsize, ldk = hd + 16 / ksize;
  const bool deq = ksize != tsize;
  const size_t ring = (size_t)stages * 2 * bs * ldk * ksize;
  const size_t tile = deq ? (size_t)2 * bs * ld * tsize : 0;
  const size_t part = (size_t)groups * rp * (hd + 10) * sizeof(float);   // m, l, acc (+8 pad)
  Layout L;
  L.ring = 0;
  L.tile = align16(ring);
  L.q = align16(L.tile + tile > part ? L.tile + tile : part);
  L.ok = L.q + align16((size_t)rp * ld * tsize);
  L.sc = L.ok + align16((size_t)stages * bs * sizeof(int));
  L.cm = L.sc + align16(deq ? (size_t)stages * 2 * bs * sizeof(float) : 0);
  L.cl = L.cm + align16(rp * sizeof(float));
  L.wts = L.cl + align16(rp * sizeof(float));
  L.extra = L.wts + align16((size_t)(NW > splits ? NW : splits) * rp * sizeof(float));
  L.total = L.extra + align16(extra_bytes);
  return L;
}

// What a call's CTAs share: shapes, the slot-tile geometry, the scale, the
// sliding window (0: none) and whether query t stops at its own position
// (causal) or every query sees all len slots.
struct Args {
  int Tq, H, KV, hd, bs, stages, splits;
  float scale;
  int window = 0;
  bool causal = true;
};

// ---- the product step, by type ---------------------------------------------

// sc[nt] += Q (16 rows of the m tile) . K^T (slots nt*8 .. nt*8+7 of the
// sub-tile), in the mma accumulator layout: lane (g, t) holds rows g, g+8 and
// slots 2t, 2t+1 of each n8 tile.
template <int HD>
__device__ __forceinline__ void scores(float (&sc)[2][4], const __nv_bfloat16* qs,
                                       const __nv_bfloat16* ks, int ld, int hd, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  const __nv_bfloat16* qa = qs + ((mi & 1) * 8 + ri) * ld + (mi >> 1) * 8;
  const __nv_bfloat16* kb = ks + ((mi >> 1) * 8 + ri) * ld + (mi & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if (kk * 16 < hd) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, qa + kk * 16);
      ldmatrix_x4(b, kb + kk * 16);
      mma_bf16_16816(sc[0], a, b[0], b[1]);
      mma_bf16_16816(sc[1], a, b[2], b[3]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void scores(float (&sc)[2][4], const float* qs, const float* ks,
                                       int ld, int hd, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* q0 = qs + g * ld;
  const float* q1 = qs + (g + 8) * ld;
  for (int d = 0; d < hd; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(q0 + d);
    const float4 a1 = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (nt * 8 + 2 * t + e) * ld + d);
        sc[nt][e] += a0.x * kv.x + a0.y * kv.y + a0.z * kv.z + a0.w * kv.w;
        sc[nt][2 + e] += a1.x * kv.x + a1.y * kv.y + a1.z * kv.z + a1.w * kv.w;
      }
    }
  }
}

// o += P (the sub-tile's probabilities, in sc's layout) . V (16 slots x hd),
// o in the accumulator layout: o[j] holds rows g, g+8 and columns
// 8j + 2t, 8j + 2t + 1.
template <int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[2][4],
                                   const __nv_bfloat16* vs, int ld, int hd, int lane) {
  const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                         pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
  const int mi = lane >> 3, ri = lane & 7;
  const __nv_bfloat16* vb = vs + ((mi & 1) * 8 + ri) * ld + (mi >> 1) * 8;
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    if (c * 16 < hd) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vb + c * 16);
      mma_bf16_16816(o[2 * c], a, b[0], b[1]);
      mma_bf16_16816(o[2 * c + 1], a, b[2], b[3]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[2][4],
                                   const float* vs, int ld, int hd, int lane) {
  const int t = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int src = 0; src < 4; ++src) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = __shfl_sync(0xffffffffu, p[nt][e], quad | src);
        const float p1 = __shfl_sync(0xffffffffu, p[nt][2 + e], quad | src);
        const float* vr = vs + (nt * 8 + 2 * src + e) * ld + 2 * t;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          if (8 * j + 2 * t < hd) {
            const float2 vv = *reinterpret_cast<const float2*>(vr + 8 * j);
            o[j][0] = fmaf(p0, vv.x, o[j][0]);
            o[j][1] = fmaf(p0, vv.y, o[j][1]);
            o[j][2] = fmaf(p1, vv.x, o[j][2]);
            o[j][3] = fmaf(p1, vv.y, o[j][3]);
          }
        }
      }
    }
  }
}

// ---- the int8 KV cache -----------------------------------------------------------

// 4 bytes from device to shared memory (cp.async.ca: the 16-byte copies'
// .cg takes no smaller size); with `fill` false nothing is read and the 4
// bytes are zeroed.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 4 : 0));
}

// 16 int8 values times their scale, each product rounded once to the
// query's type, as kv_dequantize rounds it: 16-byte stores.
__device__ __forceinline__ void dequant16(float* dst, int4 raw, float s) {
  const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4((float)q[i] * s, (float)q[i + 1] * s, (float)q[i + 2] * s, (float)q[i + 3] * s);
}
__device__ __forceinline__ void dequant16(__nv_bfloat16* dst, int4 raw, float s) {
  const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = pack_bf16((float)q[2 * i] * s, (float)q[2 * i + 1] * s);
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
}

// ---- the body ----------------------------------------------------------------

// Four outputs of a row, in the output dtype.
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// One CTA of the cluster of (lane b, kv head kvh, the row tile starting at
// row r0).  `map` says where the
// lane's slots live: map.live(len) is the number of slots to visit (at most
// the lane's capacity), map.prepare(lo, hi) stages what map.row needs for
// the share [lo, hi) in shared memory, map.row(j) is slot j's K/V row of k/v
// viewed as (rows, KV, hd) or -1 when unmapped, and map.pos(j) the position
// a mapped slot holds (-1: empty).  K/V are stored as KT: T, or int8_t with
// the float32 scales ksc / vsc viewed as (rows, KV) (null otherwise).
// Every CTA of the cluster must call it.
template <typename T, typename KT, int HD, typename Map>
__device__ __forceinline__ void flash_decode(const T* __restrict__ q, const KT* __restrict__ k,
                                             const KT* __restrict__ v,
                                             const float* __restrict__ ksc,
                                             const float* __restrict__ vsc,
                                             const int* __restrict__ lengths,
                                             T* __restrict__ out, const Args& a, Map map,
                                             int b, int kvh, int r0, unsigned char* smem) {
  constexpr bool DEQ = sizeof(KT) != sizeof(T);    // int8 storage, dequantised per tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // RT rows a tile, nr of them real in this one (the last tile may hold fewer)
  const int G = a.H / a.KV, R = a.Tq * G, RT = tile_rows(R), nr = min(RT, R - r0);
  const int MT = (RT + 15) / 16, groups = NW / MT, rp = MT * 16;
  const int hd = a.hd, ld = hd + 16 / (int)sizeof(T), bs = a.bs, nsub = bs / SUB;
  const int ldk = hd + 16 / (int)sizeof(KT);
  const int mt = warp % MT, grp = warp / MT;
  const bool active = grp < groups;          // MT = 3 leaves one warp idle
  const int per_chunk = 16 / sizeof(T), cpr = hd / per_chunk;
  const int cprk = hd / (16 / (int)sizeof(KT));   // 16-byte copies of a K/V row
  const Layout L = layout(RT, hd, sizeof(T), sizeof(KT), bs, a.stages, a.splits, 0);
  KT* ring = reinterpret_cast<KT*>(smem + L.ring);
  T* tile = reinterpret_cast<T*>(smem + L.tile);   // DEQ: K rows then V rows
  T* qs = reinterpret_cast<T*>(smem + L.q);
  int* slot_pos = reinterpret_cast<int*>(smem + L.ok);
  float* scales = reinterpret_cast<float*>(smem + L.sc);   // DEQ: a stage's K then V scales
  float* cm = reinterpret_cast<float*>(smem + L.cm);
  float* cl = reinterpret_cast<float*>(smem + L.cl);
  float* wts = reinterpret_cast<float*>(smem + L.wts);

  // the query rows of this tile first (they need no length), padded with
  // zero rows to rp; they land with the first tile's copies
  for (int i = tid; i < rp * cpr; i += THREADS) {
    const int r = i / cpr, c = (i % cpr) * per_chunk, rg = r0 + r;
    const T* src = r < nr ? q + (((size_t)b * a.Tq + rg / G) * a.H + kvh * G + rg % G) * hd + c : q;
    cp_async16(qs + r * ld + c, src, r < nr);
  }

  // this CTA's share of the lane's live slots
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int len = max(lengths[b], 0);
  const int n_live = map.live(len);
  const int share = share_slots(n_live, a.splits);
  const int lo = min(rank * share, n_live), hi = min(lo + share, n_live);
  map.prepare(lo, hi);
  __syncthreads();

  // stage `st` <- tile `it` of the share: K rows then V rows, 16 bytes a
  // copy (and each slot's two scales, 4 bytes a copy, when they are int8)
  const int n_tiles = hi > lo ? (hi - lo + bs - 1) / bs : 0;
  const int kper = 16 / (int)sizeof(KT);
  auto issue = [&](int it) {
    const int st = it % a.stages, j0 = lo + it * bs;
    KT* ks = ring + (size_t)st * 2 * bs * ldk;
    KT* vs = ks + (size_t)bs * ldk;
    for (int i = tid; i < bs * cprk; i += THREADS) {
      const int r = i / cprk, c = (i % cprk) * kper, j = j0 + r;
      const long long row = j < hi ? map.row(j) : -1;
      const size_t off = row >= 0 ? ((size_t)row * a.KV + kvh) * hd + c : 0;
      cp_async16(ks + r * ldk + c, k + off, row >= 0);
      cp_async16(vs + r * ldk + c, v + off, row >= 0);
      if (c == 0) {
        slot_pos[st * bs + r] = row >= 0 ? map.pos(j) : -1;
        if constexpr (DEQ) {
          const size_t so = row >= 0 ? (size_t)row * a.KV + kvh : 0;
          cp_async4(scales + (st * 2) * bs + r, ksc + so, row >= 0);
          cp_async4(scales + (st * 2 + 1) * bs + r, vsc + so, row >= 0);
        }
      }
    }
    cp_async_commit();
  };

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  // the positions [qbeg, qend) this thread's two rows see (none for
  // padded rows): qend = qpos + 1, qbeg = qend - W with a window, else 0
  int qend[2], qbeg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = mt * 16 + g + 8 * h;
    qend[h] = r < nr ? (a.causal ? len - (a.Tq - 1 - (r0 + r) / G) : len) : 0;
    qbeg[h] = a.window > 0 ? max(qend[h] - a.window, 0) : 0;
  }
  const float sl2 = a.scale * LOG2E;

  // the ring: up to `stages` tiles in flight; the query copies ride with
  // the first; each tile is folded once it has landed
  int issued = 0;
  for (; issued < n_tiles && issued < a.stages - 1; ++issued) issue(issued);
  for (int it = 0; it < n_tiles; ++it) {
    if (issued < n_tiles) issue(issued++);
    if (issued - it > 2)
      cp_async_wait<2>();
    else if (issued - it > 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int st = it % a.stages;
    const T* ks;
    if constexpr (DEQ) {
      // the landed int8 stage -> the T tile pair, 16 values a thread a step
      const KT* kr = ring + (size_t)st * 2 * bs * ldk;
      for (int i = tid; i < 2 * bs * cprk; i += THREADS) {
        const int half = i / (bs * cprk), rem = i % (bs * cprk);
        const int r = half * bs + rem / cprk, c = (rem % cprk) * 16;
        dequant16(tile + (size_t)r * ld + c,
                  *reinterpret_cast<const int4*>(kr + (size_t)r * ldk + c),
                  scales[st * 2 * bs + r]);
      }
      __syncthreads();
      ks = tile;
    } else {
      ks = reinterpret_cast<const T*>(ring + (size_t)st * 2 * bs * ldk);
    }
    const T* vs = ks + (size_t)bs * ld;
    for (int sub = grp; active && sub < nsub; sub += groups) {
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      scores<HD>(sc, qs + mt * 16 * ld, ks + sub * SUB * ld, ld, hd, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bool ok[2][2];
        float mx = NEG;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int sp = slot_pos[st * bs + sub * SUB + nt * 8 + 2 * t4 + e];
            ok[nt][e] = sp >= qbeg[h] && sp < qend[h];
            sc[nt][2 * h + e] *= sl2;
            if (ok[nt][e]) mx = fmaxf(mx, sc[nt][2 * h + e]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float alpha = exp2f(m[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ok[nt][e] ? exp2f(sc[nt][2 * h + e] - m_new) : 0.f;
            sc[nt][2 * h + e] = p;
            sum += p;
          }
        }
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[j][2 * h] *= alpha;
          o[j][2 * h + 1] *= alpha;
        }
      }
      pv<HD>(o, sc, vs + sub * SUB * ld, ld, hd, lane);
    }
    __syncthreads();   // the stage (and the tile) is free for the next copy
  }
  cp_async_commit();   // an empty share still issued the query copies
  cp_async_wait<0>();

  // each warp's partial (m, l, acc) into the ring, by (group, row); acc
  // rows are padded by 8 floats so the stores spread over the banks
  const int pld = hd + 8;
  float* pm = reinterpret_cast<float*>(smem + L.ring);
  float* pl = pm + groups * rp;
  float* pacc = pl + groups * rp;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (t4 == 0) {
        pm[grp * rp + r] = m[h];
        pl[grp * rp + r] = l[h];
      }
      float* dst = pacc + (size_t)(grp * rp + r) * pld + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        if (8 * j + 2 * t4 < hd)
          *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[j][2 * h], o[j][2 * h + 1]);
    }
  }
  __syncthreads();

  // the CTA's partial: per row the warp groups' weights (normalised when
  // the cluster is one CTA), then their sum, four columns a thread
  const bool alone = a.splits == 1;
  for (int r = tid; r < nr; r += THREADS) {
    float mm = NEG, ll = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (w < groups) mm = fmaxf(mm, pm[w * rp + r]);
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (w < groups) ll += pl[w * rp + r] * exp2f(pm[w * rp + r] - mm);
    const float inv = !alone ? 1.f : ll > 0.f ? 1.f / ll : 0.f;   // no slot seen: 0
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (w < groups) wts[w * rp + r] = exp2f(pm[w * rp + r] - mm) * inv;
    cm[r] = mm;
    cl[r] = ll;
  }
  __syncthreads();
  const int q4 = hd / 4;
  for (int i = tid; i < nr * q4; i += THREADS) {
    const int r = i / q4, c = (i % q4) * 4, rg = r0 + r;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w < groups) {
        const float s = wts[w * rp + r];
        const float4 p = *reinterpret_cast<const float4*>(pacc + (size_t)(w * rp + r) * pld + c);
        acc.x += s * p.x;
        acc.y += s * p.y;
        acc.z += s * p.z;
        acc.w += s * p.w;
      }
    }
    if (alone)
      store4(out + (((size_t)b * a.Tq + rg / G) * a.H + kvh * G + rg % G) * hd + c, acc);
    else
      *reinterpret_cast<float4*>(pacc + (size_t)r * pld + c) = acc;
  }
  if (alone) return;

  // the cluster's merge through distributed shared memory: every rank
  // weighs the ranks' partials per row, then writes its own slice of the
  // output, four columns a thread, reading the C partials side by side
  cluster.sync();
  for (int r = tid; r < nr; r += THREADS) {
    float mc[MAX_SPLITS], lc[MAX_SPLITS], mm = NEG, ll = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_SPLITS; ++c) {
      mc[c] = c < a.splits ? cluster.map_shared_rank(cm, c)[r] : NEG;
      lc[c] = c < a.splits ? cluster.map_shared_rank(cl, c)[r] : 0.f;
      mm = fmaxf(mm, mc[c]);
    }
#pragma unroll
    for (int c = 0; c < MAX_SPLITS; ++c) ll += lc[c] * exp2f(mc[c] - mm);
    const float inv = ll > 0.f ? 1.f / ll : 0.f;      // a row that saw no slot writes 0
#pragma unroll
    for (int c = 0; c < MAX_SPLITS; ++c)
      if (c < a.splits) wts[c * rp + r] = exp2f(mc[c] - mm) * inv;
  }
  __syncthreads();
  for (int i = rank * THREADS + tid; i < nr * q4; i += a.splits * THREADS) {
    const int r = i / q4, c = (i % q4) * 4, rg = r0 + r;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MAX_SPLITS; ++k) {
      if (k < a.splits) {
        const float s = wts[k * rp + r];
        const float4 p = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(pacc, k) + (size_t)r * pld + c);
        acc.x += s * p.x;
        acc.y += s * p.y;
        acc.z += s * p.z;
        acc.w += s * p.w;
      }
    }
    store4(out + (((size_t)b * a.Tq + rg / G) * a.H + kvh * G + rg % G) * hd + c, acc);
  }
  cluster.sync();      // no CTA leaves while another reads its shared memory
}

// ---- the host side -------------------------------------------------------------

// Fill in the tile geometry of a call whose lanes hold at most `cap` slots,
// for a CTA holding one row tile:
// tiles of up to 64 slots (32 in float32), as many stages as a share has
// tiles up to three, tiles halved until the CTA's shared memory fits.  A
// paged call (page size `ps` > 0) also holds the table entries of its share,
// a ring call (`ring`) the positions of its share's slots.  K/V stored in
// `ksize` bytes an element (1: int8) add the dequantised tile pair.
// Returns the bytes of shared memory, or 0 when nothing fits.
inline size_t plan(Args& a, int cap, int tsize, int ksize, int ps, bool ring = false) {
  const int R = tile_rows(a.Tq * (a.H / a.KV));
  const int share = share_slots(cap, a.splits);
  const size_t table = ring ? (size_t)share * sizeof(int)
                       : ps > 0 ? (size_t)(share / ps + 2) * sizeof(int) : 0;
  for (int bs = tsize == 2 ? 64 : 32; bs >= SUB; bs /= 2) {
    a.bs = bs < share ? bs : share;
    const int tiles = (share + a.bs - 1) / a.bs;
    a.stages = tiles < 3 ? tiles : 3;
    const size_t total = layout(R, a.hd, tsize, ksize, a.bs, a.stages, a.splits, table).total;
    if (total <= MAX_SMEM) return total;
  }
  return 0;
}

// Launch `Kernel` on grid (C, KV * row tiles, B) with clusters of (C, 1, 1).
// Its shared-memory limit is raised once, on its first launch.
template <auto Kernel, typename... A>
cudaError_t launch(const Args& a, int B, size_t smem, cudaStream_t s, A&&... args) {
  static const cudaError_t limit =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (limit != cudaSuccess) return limit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.KV * row_tiles(a.Tq * (a.H / a.KV)), B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;    // C = 1 runs as an implicit cluster of one
  const cudaError_t e = cudaLaunchKernelEx(&cfg, Kernel, static_cast<A&&>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The checks both entry points make before planning a call: int8 K/V rows
// take whole 16-byte copies (hd % 16).
inline bool valid(const Args& a, int B, int is_bf16, int kv_int8) {
  if (B <= 0 || a.Tq <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.hd <= 0 || a.hd > 256) return false;
  if (a.hd % (is_bf16 || kv_int8 ? 16 : 4) != 0 || a.Tq > MAX_TQ) return false;
  if ((long long)a.KV * row_tiles(a.Tq * (a.H / a.KV)) > 65535) return false;   // grid y
  return a.splits == 1 || a.splits == 2 || a.splits == 4 || a.splits == MAX_SPLITS;
}

}  // namespace attn
