// ssd_scan: the Mamba-2 SSD chunked scan with a carried float32 state.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// pallas_call at :80), whose grid (B, T/Q) walks the chunks of a sequence
// in order with the (H, hd, ds) state in VMEM scratch.  It computes what
// repro.models.ssm.ssd_chunked computes, in float32 throughout, for G = 1:
// per chunk of Q rows (cum = inclusive cumsum of dt*A over the chunk)
//
//   y[i]  = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j   (intra-chunk)
//         + exp(cum_i) C_i . h                                 (carried state)
//   h    <- h exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
//
// Hopper blocks run in no order, so the sequential chunk axis becomes a
// loop inside one block per (head, lane) that keeps the hd x ds state in
// shared memory (32 KB at hd 64, ds 128).  C.B^T is the same for every
// head (G = 1), so a pre-pass forms it once per (lane, chunk), on and below
// the diagonal only, into a float32 scratch (B, T/Q, Q, Q).  Above the
// diagonal exp(cum_i - cum_j) overflows: the decay is a select, never a
// product with a mask.  The main pass stages a chunk of x in float32, builds
// the decay-weighted row tiles of 32 rows, writes float32 y, then updates
// the state with one thread per state column s and its column's rows in
// registers.  Any 1 <= Q <= 128 works, so the odd chunks of a prefill (T <
// 128 gives Q = T) need no padding; rows a caller pads with dt = 0 leave the
// state unchanged.
//
// Bound on H100: at the sync prefill shape (B 8, T = Q = 127, H 32, hd 64,
// ds 128, bf16 inputs) the scan reads about 4.8 MB and writes 8.3 MB of
// float32 y and 8.4 MB of float32 state, about 6.4 us at 3.35 TB/s; its
// 1.35 GFLOP are float32 products (the reference computes the scan in
// float32), about 20 us at the 67 TFLOP/s float32 rate, so operations bound
// it.  This first version runs them as FMAs on the CUDA cores from shared
// memory; grid fill is B*H blocks (256 at the sync batch, 32 at a
// continuous B = 1 admission, on 132 SMs).  wgmma for the three products
// and parallel chunk states with a short inter-chunk scan are later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RT = 32;                        // rows of a y tile / of a B tile
constexpr int SPT = 32;                       // state elements a thread owns, at most

// cb[b][c][i][j] = sum_s C[b, cQ+i, s] * B[b, cQ+j, s], for j <= i < Q.
// grid (ceil(Q/RT), T/Q, B): one block per 32-row tile of one chunk.
template <typename TI>
__global__ void __launch_bounds__(THREADS)
ssd_cb(const TI* __restrict__ Bc, const TI* __restrict__ Cc, long long sbb, long long sbt,
       long long scb, long long sct, int T, int Q, int ds, float* __restrict__ cb) {
  extern __shared__ float smem[];
  const int pitch = ds + 1;                   // odd pitch: conflict-free column reads
  float* cs = smem;                           // RT x pitch rows of C
  float* bs = cs + RT * pitch;                // RT x pitch rows of B
  const int i0 = blockIdx.x * RT, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = T / Q;
  const long long t0 = (long long)c * Q;
  for (int e = tid; e < RT * ds; e += THREADS) {
    const int r = e / ds, s = e % ds, i = i0 + r;
    cs[r * pitch + s] = i < Q ? to_f32(Cc[b * scb + (t0 + i) * sct + s]) : 0.f;
  }
  float* out = cb + ((size_t)b * nc + c) * Q * Q;
  const int jj = tid % RT;
  for (int j0 = 0; j0 < Q && j0 < i0 + RT; j0 += RT) {     // tiles on or below the diagonal
    __syncthreads();
    for (int e = tid; e < RT * ds; e += THREADS) {
      const int r = e / ds, s = e % ds, j = j0 + r;
      bs[r * pitch + s] = j < Q ? to_f32(Bc[b * sbb + (t0 + j) * sbt + s]) : 0.f;
    }
    __syncthreads();
    for (int ii = tid / RT; ii < RT; ii += THREADS / RT) {
      const int i = i0 + ii, j = j0 + jj;
      if (i < Q && j <= i) {
        float acc = 0.f;
        for (int s = 0; s < ds; ++s) acc = fmaf(cs[ii * pitch + s], bs[jj * pitch + s], acc);
        out[(size_t)i * Q + j] = acc;
      }
    }
  }
}

// grid (H, B): one block walks the chunks of one (head, lane) in order.
template <typename TI>
__global__ void __launch_bounds__(THREADS)
ssd_chunks(const TI* __restrict__ xh, const TI* __restrict__ Bc, const TI* __restrict__ Cc,
           const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ h0, const float* __restrict__ cb,
           long long sxb, long long sxt, long long sbb, long long sbt, long long scb,
           long long sct, int T, int H, int hd, int ds, int Q, float* __restrict__ y,
           float* __restrict__ hout) {
  extern __shared__ float smem[];
  const int pitch = ds + 1;
  float* hs = smem;                           // hd x pitch  the carried state
  float* xs = hs + hd * pitch;                // Q x hd      x of the chunk
  float* ws = xs + Q * hd;                    // RT x Q      decay weights of a row tile
  float* ts = ws + RT * Q;                    // RT x ds     C rows (y) / weighted B rows (state)
  float* cum = ts + RT * ds;                  // Q
  float* dts = cum + Q;                       // Q
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int nc = T / Q;
  const float a = A[h];
  const int s_own = tid % ds;                 // the state column this thread updates
  const int p0 = tid / ds, pstep = THREADS / ds;

  for (int e = tid; e < hd * ds; e += THREADS) {
    const int p = e / ds, s = e % ds;
    hs[p * pitch + s] = h0 ? h0[(((size_t)b * H + h) * hd + p) * ds + s] : 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * Q;
    __syncthreads();                          // the previous chunk is done with xs, cum
    for (int j = tid; j < Q; j += THREADS) dts[j] = dt[((size_t)b * T + t0 + j) * H + h];
    for (int e = tid; e < Q * hd; e += THREADS) {
      const int j = e / hd, p = e % hd;
      xs[e] = to_f32(xh[b * sxb + (t0 + j) * sxt + (long long)h * hd + p]);
    }
    __syncthreads();
    if (tid == 0) {                           // inclusive cumsum, in row order
      float run = 0.f;
      for (int j = 0; j < Q; ++j) {
        run += dts[j] * a;
        cum[j] = run;
      }
    }
    __syncthreads();
    const float* cbc = cb + ((size_t)b * nc + c) * Q * Q;

    // ---- y, one tile of RT rows at a time (reads the state before the update)
    for (int i0 = 0; i0 < Q; i0 += RT) {
      const int rows = min(RT, Q - i0), jmax = i0 + rows;
      for (int e = tid; e < rows * jmax; e += THREADS) {
        const int r = e / jmax, j = e % jmax, i = i0 + r;
        float w = 0.f;
        if (j <= i) w = cbc[(size_t)i * Q + j] * expf(cum[i] - cum[j]) * dts[j];
        ws[r * Q + j] = w;
      }
      for (int e = tid; e < rows * ds; e += THREADS) {
        const int r = e / ds, s = e % ds;
        ts[e] = to_f32(Cc[b * scb + (t0 + i0 + r) * sct + s]);
      }
      __syncthreads();
      for (int e = tid; e < rows * hd; e += THREADS) {
        const int r = e / hd, p = e % hd, i = i0 + r;
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(ws[r * Q + j], xs[j * hd + p], intra);
        float inter = 0.f;
        for (int s = 0; s < ds; ++s) inter = fmaf(ts[r * ds + s], hs[p * pitch + s], inter);
        y[(((size_t)b * T + t0 + i) * H + h) * hd + p] = intra + inter * expf(cum[i]);
      }
      __syncthreads();
    }

    // ---- state update: thread owns column s_own, rows p0, p0 + pstep, ...
    const float cl = cum[Q - 1];
    float acc[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) acc[k] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += RT) {
      const int rows = min(RT, Q - j0);
      for (int e = tid; e < rows * ds; e += THREADS) {
        const int r = e / ds, s = e % ds, j = j0 + r;
        ts[e] = expf(cl - cum[j]) * dts[j] * to_f32(Bc[b * sbb + (t0 + j) * sbt + s]);
      }
      __syncthreads();
      for (int r = 0; r < rows; ++r) {
        const float bv = ts[r * ds + s_own];
        const float* xr = xs + (j0 + r) * hd;
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const int p = p0 + k * pstep;
          if (p < hd) acc[k] = fmaf(bv, xr[p], acc[k]);
        }
      }
      __syncthreads();
    }
    const float dl = expf(cl);
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int p = p0 + k * pstep;
      if (p < hd) hs[p * pitch + s_own] = hs[p * pitch + s_own] * dl + acc[k];
    }
  }
  __syncthreads();
  for (int e = tid; e < hd * ds; e += THREADS) {
    const int p = e / ds, s = e % ds;
    hout[(((size_t)b * H + h) * hd + p) * ds + s] = hs[p * pitch + s];
  }
}

template <typename TI>
cudaError_t run(const void* xh, const void* Bc, const void* Cc, const float* dt,
                const float* A, const float* h0, long long sxb, long long sxt, long long sbb,
                long long sbt, long long scb, long long sct, int B, int T, int H, int hd,
                int ds, int Q, float* cb, float* y, float* hout, cudaStream_t s) {
  const TI* xp = static_cast<const TI*>(xh);
  const TI* bp = static_cast<const TI*>(Bc);
  const TI* cp = static_cast<const TI*>(Cc);
  const size_t smem_cb = 2 * (size_t)RT * (ds + 1) * sizeof(float);
  cudaError_t e = allow_smem(ssd_cb<TI>, smem_cb);
  if (e != cudaSuccess) return e;
  ssd_cb<TI><<<dim3((Q + RT - 1) / RT, T / Q, B), THREADS, smem_cb, s>>>(
      bp, cp, sbb, sbt, scb, sct, T, Q, ds, cb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = ((size_t)hd * (ds + 1) + (size_t)Q * hd + (size_t)RT * Q +
                       (size_t)RT * ds + 2 * (size_t)Q) * sizeof(float);
  e = allow_smem(ssd_chunks<TI>, smem);
  if (e != cudaSuccess) return e;
  ssd_chunks<TI><<<dim3(H, B), THREADS, smem, s>>>(xp, bp, cp, dt, A, h0, cb, sxb, sxt, sbb,
                                                   sbt, scb, sct, T, H, hd, ds, Q, y, hout);
  return cudaGetLastError();
}

}  // namespace

// xh (B,T,H,hd), Bc/Cc (B,T,1,ds) with the given batch and time strides (in
// elements; the inner dimensions packed), dt (B,T,H) f32 contiguous, A (H,)
// f32, h0 (B,H,hd,ds) f32 or null; cb a (B, T/Q, Q, Q) f32 scratch; outputs
// y (B,T,H,hd) f32 and hout (B,H,hd,ds) f32, contiguous.
DVI_EXPORT int dvi_ssd_scan(const void* xh, const void* Bc, const void* Cc, const void* dt,
                            const void* A, const void* h0, long long sxb, long long sxt,
                            long long sbb, long long sbt, long long scb, long long sct, int B,
                            int T, int H, int hd, int ds, int Q, int is_bf16, void* cb,
                            void* y, void* hout, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || hd <= 0 || hd > 128 || ds <= 0 || ds > 128 ||
      THREADS % ds != 0 || hd > SPT * (THREADS / ds) || Q < 1 || Q > 128 || T % Q != 0)
    return cudaErrorInvalidValue;
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float* cbp = static_cast<float*>(cb);
  float* yp = static_cast<float*>(y);
  float* hp = static_cast<float*>(hout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(xh, Bc, Cc, dtp, ap, h0p, sxb, sxt, sbb, sbt, scb, sct,
                                      B, T, H, hd, ds, Q, cbp, yp, hp, s)
                 : run<float>(xh, Bc, Cc, dtp, ap, h0p, sxb, sxt, sbb, sbt, scb, sct, B, T, H,
                              hd, ds, Q, cbp, yp, hp, s);
}
