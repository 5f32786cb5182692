// lora_logits: the LoRA draft head, h@w + gamma*(h@a)@b in float32.
//
// Replaces the Pallas kernel src/repro/kernels/lora_logits.py (lora_logits,
// pallas_call at :53), which computes u = h@a once per row block into VMEM
// scratch at the first vocab tile and reuses it across the sequential vocab
// axis.  Hopper blocks run in no order, so u is formed first, by a small
// pre-pass over d-slices into a (ksplit, T, r) float32 scratch (2 KB per
// slice at T = 8, r = 64) that the main pass sums in slice order; the main
// pass streams w in 64-column tiles (vocab_tile.cuh) and adds
// gamma * u @ b[:, tile] before its one write of the float32 logits.
//
// Bound on H100: the bytes of w, b and the logits (about 271 MB per launch
// at vicuna-7b in bf16 with T = 8, r = 64, about 81 us at 3.35 TB/s); at
// T = 8 the FMAs are well below the CUDA cores' rate, so the design's job
// is to read w once, coalesced, and write the logits once.
#include "vocab_tile.cuh"

namespace {

constexpr int DOWN_THREADS = 128;

// u_part[ks][t][j] = sum over k in slice ks of h[t][k] * a[k][j].
template <typename TI>
__global__ void __launch_bounds__(DOWN_THREADS)
lora_down(const TI* __restrict__ h, const float* __restrict__ a, int T, int d, int r,
          int ksplit, float* __restrict__ u_part) {
  const int ks = blockIdx.x, t = blockIdx.y;
  const int chunk = (d + ksplit - 1) / ksplit;
  const int kbeg = ks * chunk;
  const int kend = min(d, kbeg + chunk);
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    float s = 0.f;
    for (int k = kbeg; k < kend; ++k)
      s = fmaf(to_f32(h[(size_t)t * d + k]), a[(size_t)k * r + j], s);
    u_part[((size_t)ks * T + t) * r + j] = s;
  }
}

template <typename TI, int RT>
__global__ void __launch_bounds__(vocab::THREADS)
lora_main(const TI* __restrict__ h, const TI* __restrict__ w,
          const float* __restrict__ u_part, const float* __restrict__ b, float gamma,
          int T, int d, int V, int r, int ksplit, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* red = hs + vocab::DC * RT;
  float* us = red + RT * vocab::COLS;          // (RT, r) rows of u
  const int c0 = blockIdx.x * vocab::COLS;
  for (int r0 = 0; r0 < T; r0 += RT) {
    for (int i = threadIdx.x; i < RT * r; i += vocab::THREADS) {
      const int row = r0 + i / r, j = i % r;
      float s = 0.f;
      if (row < T)
        for (int ks = 0; ks < ksplit; ++ks) s += u_part[((size_t)ks * T + row) * r + j];
      us[i] = s;
    }
    // tile() synchronises before it returns, which also publishes us
    vocab::tile<TI, RT>(h, w, T, d, V, r0, c0, hs, red);
    for (int e = threadIdx.x; e < RT * vocab::COLS; e += vocab::THREADS) {
      const int rr = e / vocab::COLS, c = c0 + e % vocab::COLS;
      if (r0 + rr < T && c < V) {
        float lo = 0.f;
        for (int j = 0; j < r; ++j) lo = fmaf(us[rr * r + j], b[(size_t)j * V + c], lo);
        out[(size_t)(r0 + rr) * V + c] = red[e] + gamma * lo;
      }
    }
    __syncthreads();
  }
}

template <typename TI, int RT>
cudaError_t launch_main(const TI* h, const TI* w, const float* up, const float* b,
                        float gamma, int T, int d, int V, int r, int ksplit, float* out,
                        cudaStream_t s) {
  const size_t smem = (vocab::tile_smem_floats(RT) + (size_t)RT * r) * sizeof(float);
  cudaError_t e = allow_smem(lora_main<TI, RT>, smem);
  if (e != cudaSuccess) return e;
  const int nblk = (V + vocab::COLS - 1) / vocab::COLS;
  lora_main<TI, RT><<<nblk, vocab::THREADS, smem, s>>>(h, w, up, b, gamma, T, d, V, r,
                                                        ksplit, out);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t run(const void* h, const void* w, const float* a, const float* b, float gamma,
                int T, int d, int V, int r, float* up, int ksplit, float* out,
                cudaStream_t s) {
  const TI* hp = static_cast<const TI*>(h);
  const TI* wp = static_cast<const TI*>(w);
  lora_down<TI><<<dim3(ksplit, T), DOWN_THREADS, 0, s>>>(hp, a, T, d, r, ksplit, up);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (vocab::rows_per_pass(T)) {
    case 8:  return launch_main<TI, 8>(hp, wp, up, b, gamma, T, d, V, r, ksplit, out, s);
    case 16: return launch_main<TI, 16>(hp, wp, up, b, gamma, T, d, V, r, ksplit, out, s);
    case 24: return launch_main<TI, 24>(hp, wp, up, b, gamma, T, d, V, r, ksplit, out, s);
    case 32: return launch_main<TI, 32>(hp, wp, up, b, gamma, T, d, V, r, ksplit, out, s);
    case 40: return launch_main<TI, 40>(hp, wp, up, b, gamma, T, d, V, r, ksplit, out, s);
    default: return launch_main<TI, 48>(hp, wp, up, b, gamma, T, d, V, r, ksplit, out, s);
  }
}

}  // namespace

DVI_EXPORT int dvi_lora_logits(const void* h, const void* w, const void* a, const void* b,
                               float gamma, int T, int d, int V, int r, int is_bf16,
                               void* u_part, int ksplit, void* out, void* stream) {
  if (T <= 0 || d <= 0 || V <= 0 || r <= 0 || ksplit <= 0) return cudaErrorInvalidValue;
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* up = static_cast<float*>(u_part);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(h, w, ap, bp, gamma, T, d, V, r, up, ksplit, op, s)
                 : run<float>(h, w, ap, bp, gamma, T, d, V, r, up, ksplit, op, s);
}
