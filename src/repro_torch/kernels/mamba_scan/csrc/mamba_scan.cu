// Mamba1 (S6) selective scan, float32.
//
// Replaces the Pallas TPU kernel ``_scan_kernel`` in
// src/repro/kernels/mamba_scan/mamba_scan.py (launched by
// selective_scan_pallas through pl.pallas_call, behind the padding wrapper
// ops.py::selective_scan).  For u, dt (B, T, D), Bm, Cm (B, T, N), A (D, N)
// and h0 (B, D, N) it computes, for t = 0 .. T-1,
//
//     h[b,d,n] = exp(dt[b,t,d] * A[d,n]) * h[b,d,n]
//                + (dt[b,t,d] * u[b,t,d]) * Bm[b,t,n]
//     y[b,t,d] = sum_n h[b,d,n] * Cm[b,t,n]
//
// from h = h0, and writes y (B, T, D) and the final state hT (B, D, N).
//
// What bounds it on an H100: the two bounds are close.  Bytes: u and dt
// read and y written, (B, T, D) floats each, plus the much smaller Bm, Cm,
// A, h0 and hT: about 12 * B * T * D bytes, 100 MB at B=4, T=256, D=8192,
// 30 us at 3.35 TB/s.  Operations: one exp per (b, t, d, n), 134 M there;
// the special-function units give 16 per SM per clock, about 4.2e12/s,
// 32 us.  Each exp is a full-precision expf (a few FMAs around the
// hardware ex2), and the recurrence adds a multiply-add or two and a
// log2(N)-step shuffle sum per element, so instruction issue, not bytes,
// is what this kernel runs into first.
//
// What the design does about it:
//   * the TPU kernel carried h across a sequential grid axis over T chunks;
//     here the loop over T runs inside each thread and h never leaves a
//     register;
//   * one thread per (b, d, n): the N states of a channel sit in N adjacent
//     lanes of a warp, so y[b,t,d] is an xor-shuffle sum over those lanes,
//     and a block of 256 threads covers 256 / N channels.  That is
//     B * D * N threads, 524,288 at B=4, D=8192, N=16; one thread per
//     (b, d) would leave each SM about 8 warps for a latency-bound loop;
//   * the T axis is walked in chunks of 32 steps.  For each chunk the block
//     stages its channels' u and dt, and the chunk's Bm and Cm rows (which
//     every channel of the block shares), in shared memory with coalesced
//     loads; y is gathered in shared memory and written back a chunk at a
//     time, contiguous along d;
//   * the ragged T and D are masked, nothing is padded (the Pallas
//     wrapper's padding to 128 x 256 blocks goes away);
//   * expf, not __expf: the fast intrinsic's error would not hold the
//     1e-4 tolerance over a long recurrence.
// N must be a power of two from 4 to 32 (falcon-mamba-7b's is 16).  The
// kernel does not synchronise and allocates nothing; the wrapper
// (mamba_scan.py) owns the outputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;                      // time steps staged per pass
constexpr int kMinState = 4;
constexpr int kMaxState = 32;
constexpr int kMaxChannels = kThreads / kMinState;  // 64

struct Strides {  // in elements, for the batch and time dims
  int64_t b, t;
};

__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_mat,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out, int seq, int dim, int state,
                      Strides us, Strides dts, Strides bs, Strides cs) {
  __shared__ float u_s[kChunk][kMaxChannels];
  __shared__ float dt_s[kChunk][kMaxChannels];
  __shared__ float y_s[kChunk][kMaxChannels];
  __shared__ float b_s[kChunk][kMaxState];
  __shared__ float c_s[kChunk][kMaxState];

  const int channels = kThreads / state;  // channels in this block
  const int tid = threadIdx.x;
  const int c = tid / state;
  const int n = tid % state;
  const int d0 = blockIdx.x * channels;
  const int d = d0 + c;
  const int b = blockIdx.y;
  const bool active = d < dim;

  const int64_t hd = (static_cast<int64_t>(b) * dim + d) * state + n;
  float h = active ? h0[hd] : 0.0f;
  const float a = active ? a_mat[static_cast<int64_t>(d) * state + n] : 0.0f;

  const float* ub = u + b * us.b;
  const float* dtb = dt + b * dts.b;
  const float* bb = bm + b * bs.b;
  const float* cb = cm + b * cs.b;
  float* yb = y + static_cast<int64_t>(b) * seq * dim;

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int len = min(kChunk, seq - t0);
    for (int e = tid; e < len * channels; e += kThreads) {
      const int r = e / channels;
      const int cc = e % channels;
      const int dd = d0 + cc;
      const int64_t t = t0 + r;
      u_s[r][cc] = dd < dim ? ub[t * us.t + dd] : 0.0f;
      dt_s[r][cc] = dd < dim ? dtb[t * dts.t + dd] : 0.0f;
    }
    for (int e = tid; e < len * state; e += kThreads) {
      const int r = e / state;
      const int nn = e % state;
      const int64_t t = t0 + r;
      b_s[r][nn] = bb[t * bs.t + nn];
      c_s[r][nn] = cb[t * cs.t + nn];
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < len; ++r) {
      const float dtv = dt_s[r][c];
      h = expf(dtv * a) * h + (dtv * u_s[r][c]) * b_s[r][n];
      float yv = h * c_s[r][n];
      for (int off = state >> 1; off > 0; off >>= 1) {
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      }
      if (n == 0) y_s[r][c] = yv;
    }
    __syncthreads();

    for (int e = tid; e < len * channels; e += kThreads) {
      const int r = e / channels;
      const int cc = e % channels;
      const int dd = d0 + cc;
      if (dd < dim) yb[static_cast<int64_t>(t0 + r) * dim + dd] = y_s[r][cc];
    }
    // the next chunk's staging writes u_s, dt_s, b_s and c_s, which no
    // thread reads any more; y_s is written again only after the next
    // barrier, by which time every thread has stored this chunk's y
  }
  if (active) h_out[hd] = h;
}

}  // namespace

extern "C" {

// The scan on ``stream``, on the current device.  Strides are in elements,
// for the batch and time dims of u, dt, Bm and Cm, whose last dim is
// contiguous; A, h0 and the outputs y (B, T, D) and hT (B, D, N) are
// contiguous.  batch, seq and dim > 0 are the caller's to ensure.  Returns
// the first CUDA error of the launch (0 == cudaSuccess), or
// cudaErrorInvalidValue for an N it does not take.
int repro_selective_scan(const void* u, const void* dt, const void* bm,
                         const void* cm, const void* a, const void* h0,
                         void* y, void* h_out, int batch, int seq, int dim,
                         int state, int64_t u_sb, int64_t u_st,
                         int64_t dt_sb, int64_t dt_st, int64_t b_sb,
                         int64_t b_st, int64_t c_sb, int64_t c_st,
                         void* stream) {
  if (state < kMinState || state > kMaxState || (state & (state - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int channels = kThreads / state;
  const dim3 grid((dim + channels - 1) / channels, batch);
  selective_scan_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), seq, dim, state,
      Strides{u_sb, u_st}, Strides{dt_sb, dt_st}, Strides{b_sb, b_st},
      Strides{c_sb, c_st});
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
