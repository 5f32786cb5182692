// One (rows x 64 vocab columns) tile of h @ w, the core that the two
// vocab-streaming kernels (verify_argmax.cu, lora_logits.cu) share.
//
// Both stream w (d, V) once: each block owns 64 adjacent vocab columns and
// walks all of d, so every element of w is read by exactly one block, with a
// warp reading 64 adjacent columns (128 or 256 contiguous bytes) of one row
// of w at a time.  h is small (T <= a few dozen rows) and is staged through
// shared memory in d-chunks of DC as float32, laid out [k][row] so a thread
// reads four rows in one 16-byte load.  The eight warps of a block split
// each d-chunk between them and their partial sums are added in warp order
// at the end, so every column is summed in the same order: equal columns of
// w give bit-equal logits, which is what makes argmax ties exact.
//
// This is the plain first version: float32 FMAs on the CUDA cores, no
// tensor cores, no TMA, no pipelining.
#pragma once

#include "common.cuh"

namespace vocab {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int COLS = 64;      // vocab columns per block: 32 lanes x 2
constexpr int DC = 128;       // d-chunk of h staged in shared memory
constexpr int MAX_RT = 48;    // rows of h per pass over w

// Rows per pass for T rows: T rounded up to a multiple of 8, at most MAX_RT.
inline int rows_per_pass(int T) {
  int rows = T < MAX_RT ? T : MAX_RT;
  return ((rows + 7) / 8) * 8;
}

// Shared-memory floats that tile<RT> uses: hs (DC x RT) then red (RT x COLS).
constexpr int tile_smem_floats(int rt) { return DC * rt + rt * COLS; }

// red[r * COLS + c] <- sum_k h[r0 + r][k] * w[k][c0 + c] in float32, for
// r < RT and c < COLS; rows >= T and columns >= V come out as 0.  Ends with
// __syncthreads(), so red is readable by every thread on return.
template <typename TI, int RT>
__device__ __forceinline__ void tile(const TI* __restrict__ h, const TI* __restrict__ w,
                                     int T, int d, int V, int r0, int c0,
                                     float* hs, float* red) {
  static_assert(RT % 4 == 0, "rows come in groups of four");
  constexpr int KW = DC / NWARP;          // rows of w per warp per d-chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = c0 + 2 * lane;
  const bool pair = (V % 2 == 0) && (col + 1 < V);
  float acc[RT][2];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    acc[r][0] = 0.f;
    acc[r][1] = 0.f;
  }
  for (int k0 = 0; k0 < d; k0 += DC) {
    for (int i = tid; i < RT * DC; i += THREADS) {
      const int r = i / DC, kk = i % DC;
      const int row = r0 + r, k = k0 + kk;
      hs[kk * RT + r] = (row < T && k < d) ? to_f32(h[(size_t)row * d + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = warp * KW; kk < (warp + 1) * KW; ++kk) {
      const int k = k0 + kk;
      if (k < d) {
        const TI* wr = w + (size_t)k * V + col;
        float w0 = 0.f, w1 = 0.f;
        if (pair) {
          load2(wr, w0, w1);
        } else {
          if (col < V) w0 = to_f32(wr[0]);
          if (col + 1 < V) w1 = to_f32(wr[1]);
        }
        const float4* hv = reinterpret_cast<const float4*>(hs + kk * RT);
#pragma unroll
        for (int r4 = 0; r4 < RT / 4; ++r4) {
          const float4 x = hv[r4];
          acc[4 * r4 + 0][0] = fmaf(x.x, w0, acc[4 * r4 + 0][0]);
          acc[4 * r4 + 0][1] = fmaf(x.x, w1, acc[4 * r4 + 0][1]);
          acc[4 * r4 + 1][0] = fmaf(x.y, w0, acc[4 * r4 + 1][0]);
          acc[4 * r4 + 1][1] = fmaf(x.y, w1, acc[4 * r4 + 1][1]);
          acc[4 * r4 + 2][0] = fmaf(x.z, w0, acc[4 * r4 + 2][0]);
          acc[4 * r4 + 2][1] = fmaf(x.z, w1, acc[4 * r4 + 2][1]);
          acc[4 * r4 + 3][0] = fmaf(x.w, w0, acc[4 * r4 + 3][0]);
          acc[4 * r4 + 3][1] = fmaf(x.w, w1, acc[4 * r4 + 3][1]);
        }
      }
    }
    __syncthreads();
  }
  // add the warps' partial sums in warp order (fixed summation order)
  for (int wi = 0; wi < NWARP; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float* dst = red + r * COLS + 2 * lane;
        dst[0] = (wi == 0 ? 0.f : dst[0]) + acc[r][0];
        dst[1] = (wi == 0 ? 0.f : dst[1]) + acc[r][1];
      }
    }
    __syncthreads();
  }
}

}  // namespace vocab
