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
// the special-function units (SFU) give 16 per SM per clock, about
// 4.2e12/s, 32 us.  Besides the exp, each (t, d, n) needs four FP32
// instructions (the exponent's multiply, dt*u*B, the FMA into h and the FMA
// into y), so the SFU and the instruction issue together set the pace.
//
// What the design does about it:
//   * a channel (b, d) belongs to LAYOUT = 1, 2 or 4 adjacent threads of a
//     warp, each of which keeps N / LAYOUT of its states, and A * log2(e)
//     for them, in registers for the whole loop over T.  dt * u is formed
//     once a step, the exp is one ex2.approx.ftz (a single MUFU.EX2, no
//     range reduction), and y is summed in registers in state order, then
//     across the channel's threads with log2(LAYOUT) xor-shuffles;
//   * the layout is picked per call from B * D (layout_for below, mirrored
//     by mamba_scan.py's layout_for): one thread a channel when B * D
//     channels alone give every scheduler of the card a warp
//     (falcon-mamba-7b's serve shape, 32768 channels), more threads a
//     channel when they do not (a single long prompt, 8192 channels, takes
//     2);
//   * T is walked in chunks of 16 or 32 steps through a ring of 3 or 4
//     shared-memory buffers (Ring) filled with cp.async: u and dt of the
//     block's channels (rows contiguous along d, 16-byte copies where
//     aligned) and the chunk's Bm and Cm rows, which every channel of the
//     block shares and reads as 16-byte broadcasts.  Two or three chunks
//     are in flight while one is scanned, and the one __syncthreads a chunk
//     is the hand-over of the buffer;
//   * y is stored by the thread that summed it, 128 bytes a warp along d
//     at one thread a channel; h0 and hT are read and written once, in
//     16-byte pieces where aligned;
//   * the ragged T and D are masked, nothing is padded (the Pallas
//     wrapper's padding to 128 x 256 blocks goes away).
// ex2.approx.ftz.f32 has a relative error of about 2^-22, and folding
// log2(e) into A rounds the exponent once more, so exp(x) is off by about
// |x| * 2^-24 relatively: 1e-6 at the |dt * A| ~ 20 that falcon-mamba's
// A = -(1..16) and softplus dt reach, where the factor itself is 2e-9.
// Measured on an H100 (chip_smoke.py phase 8): at the model's range the
// largest difference from the plain version (torch.exp) is 1.5e-5 of
// rtol/atol 1e-4, and 4.3e-6 over 4096 steps.
// N must be a power of two from 4 to 32 (falcon-mamba-7b's is 16).  The
// kernel does not synchronise and allocates nothing; the wrapper
// (mamba_scan.py) owns the outputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// one warp on each of an H100's 132 x 4 schedulers, rounded down to a power
// of two: the threads a launch needs before a layout of more threads a
// channel would only add per-step work
constexpr int kWaveThreads = 16384;
constexpr float kLog2e = 1.4426950408889634f;

// The ring of a layout: kChunk time steps a buffer, kStages buffers (so
// kStages - 1 chunks in flight), and the steps unrolled together.  One
// thread a channel keeps 16 steps fully unrolled, which its 2N state and A
// registers leave room for; more threads a channel hold fewer states and
// take longer chunks, which halves the barriers and lengthens the reach of
// the loads (chosen by timing on an H100, PERF.md)
template <int kLayout>
struct Ring {
  static constexpr int kChunk = kLayout == 1 ? 16 : 32;
  static constexpr int kStages = kLayout == 1 ? 3 : 4;
  static constexpr int kUnroll = kLayout == 1 ? 16 : 8;
};

struct Strides {  // in elements, for the batch and time dims
  int64_t b, t;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest kPending ones has landed
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// floats of one buffer: u and dt rows of the block's channels, Bm and Cm
// rows of the state
__host__ __device__ constexpr int stage_floats(int chunk, int channels,
                                               int state) {
  return chunk * (2 * channels + 2 * state);
}

// rows [0, len) of a (time, kWidth) tile whose row r starts at src + r * st,
// into dst[r * kWidth + col] for the cols [0, cols) (cols may exceed
// kWidth).  16-byte copies when ``vec``: the rows' starts are 16-byte
// aligned and cols is a multiple of 4 or at least kWidth.  The trip count is
// fixed, so the loop unrolls into predicated copies
template <int kChunk, int kWidth>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int64_t st, int len, int cols,
                                           bool vec, int tid) {
  if (vec) {
    constexpr int kGroups = kWidth / 4;
    constexpr int kTotal = kChunk * kGroups;
#pragma unroll
    for (int i = 0; i < (kTotal + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kGroups;
      const int col = (e % kGroups) * 4;
      if ((kTotal % kThreads == 0 || e < kTotal) && r < len && col < cols) {
        cp_async16(dst + r * kWidth + col, src + r * st + col);
      }
    }
  } else {
    constexpr int kTotal = kChunk * kWidth;
#pragma unroll
    for (int i = 0; i < (kTotal + kThreads - 1) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kWidth;
      const int col = e % kWidth;
      if ((kTotal % kThreads == 0 || e < kTotal) && r < len && col < cols) {
        cp_async4(dst + r * kWidth + col, src + r * st + col);
      }
    }
  }
}

template <int S>
__device__ __forceinline__ void load_states(float* out, const float* src,
                                            bool vec) {
  if constexpr (S % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < S; k += 4) {
        const float4 q = *reinterpret_cast<const float4*>(src + k);
        out[k] = q.x; out[k + 1] = q.y; out[k + 2] = q.z; out[k + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) out[k] = src[k];
}

template <int S>
__device__ __forceinline__ void store_states(float* dst, const float* in,
                                             bool vec) {
  if constexpr (S % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < S; k += 4) {
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(in[k], in[k + 1], in[k + 2], in[k + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) dst[k] = in[k];
}

// kState = N; kLayout threads a channel, each with kState / kLayout states
template <int kState, int kLayout>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_mat,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_out, int seq, int dim,
                      Strides us, Strides dts, Strides bs, Strides cs,
                      bool vec_ud, bool vec_bc, bool vec_h) {
  constexpr int S = kState / kLayout;            // states a thread
  constexpr int kChannels = kThreads / kLayout;  // channels a block
  constexpr int kChunk = Ring<kLayout>::kChunk;
  constexpr int kStages = Ring<kLayout>::kStages;
  constexpr int kUnroll = Ring<kLayout>::kUnroll;
  constexpr int kStage = stage_floats(kChunk, kChannels, kState);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int c = tid / kLayout;
  const int n0 = (tid % kLayout) * S;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const int b = blockIdx.y;
  const bool active = d < dim;

  float h[S], a2[S];
  const int64_t hd = (static_cast<int64_t>(b) * dim + d) * kState + n0;
  if (active) {
    load_states<S>(h, h0 + hd, vec_h);
    load_states<S>(a2, a_mat + static_cast<int64_t>(d) * kState + n0, vec_h);
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k) h[k] = a2[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < S; ++k) a2[k] *= kLog2e;

  const float* ub = u + b * us.b + d0;
  const float* dtb = dt + b * dts.b + d0;
  const float* bb = bm + b * bs.b;
  const float* cb = cm + b * cs.b;

  auto stage = [&](int chunk) {
    float* buf = smem + (chunk % kStages) * kStage;
    const int t0 = chunk * kChunk;
    const int len = min(kChunk, seq - t0);
    stage_tile<kChunk, kChannels>(buf, ub + t0 * us.t, us.t, len, dim - d0,
                                  vec_ud, tid);
    stage_tile<kChunk, kChannels>(buf + kChunk * kChannels, dtb + t0 * dts.t,
                                  dts.t, len, dim - d0, vec_ud, tid);
    float* bc = buf + 2 * kChunk * kChannels;
    stage_tile<kChunk, kState>(bc, bb + t0 * bs.t, bs.t, len, kState, vec_bc,
                               tid);
    stage_tile<kChunk, kState>(bc + kChunk * kState, cb + t0 * cs.t, cs.t,
                               len, kState, vec_bc, tid);
  };

  // one commit group a chunk, empty past the last chunk, so that the count
  // of groups in flight is the same at every wait
  const int chunks = (seq + kChunk - 1) / kChunk;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < chunks) stage(i);
    cp_async_commit();
  }

  // y is stored by the channel's first thread, through a pointer that
  // walks down the time rows, so that the store is one predicated
  // instruction and the steps of a chunk stay one block of code the
  // compiler can interleave
  const bool stores = active && n0 == 0;
  float* yp = y + static_cast<int64_t>(b) * seq * dim + d;
  auto step = [&](const float* buf, int r) {
    const float* u_s = buf;
    const float* dt_s = buf + kChunk * kChannels;
    const float* b_s = buf + 2 * kChunk * kChannels + n0;
    const float* c_s = b_s + kChunk * kState;
    const float dtv = dt_s[r * kChannels + c];
    const float dtu = dtv * u_s[r * kChannels + c];
    float bv[S], cv[S];
    load_states<S>(bv, b_s + r * kState, true);
    load_states<S>(cv, c_s + r * kState, true);
    float yv = 0.0f;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      h[k] = fmaf(ex2(dtv * a2[k]), h[k], dtu * bv[k]);
      yv = fmaf(h[k], cv[k], yv);
    }
    if constexpr (kLayout >= 2) yv += __shfl_xor_sync(0xffffffffu, yv, 1);
    if constexpr (kLayout >= 4) yv += __shfl_xor_sync(0xffffffffu, yv, 2);
    if (stores) *yp = yv;
    yp += dim;
  };

  for (int chunk = 0; chunk < chunks; ++chunk) {
    // groups 0 .. chunk + kStages - 2 are committed; waiting for all but
    // the newest kStages - 2 lands this chunk's.  The barrier also says
    // every thread is done with chunk - 1's buffer, which is the one the
    // copies below refill
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (chunk + kStages - 1 < chunks) stage(chunk + kStages - 1);
    cp_async_commit();

    const float* buf = smem + (chunk % kStages) * kStage;
    const int len = min(kChunk, seq - chunk * kChunk);
    if (len == kChunk) {
#pragma unroll kUnroll
      for (int r = 0; r < kChunk; ++r) step(buf, r);
    } else {
      for (int r = 0; r < len; ++r) step(buf, r);
    }
  }
  if (active) store_states<S>(h_out + hd, h, vec_h);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int kState, int kLayout>
int launch(const float* u, const float* dt, const float* bm, const float* cm,
           const float* a, const float* h0, float* y, float* h_out, int batch,
           int seq, int dim, Strides us, Strides dts, Strides bs, Strides cs,
           cudaStream_t stream) {
  constexpr int kChannels = kThreads / kLayout;
  constexpr int kSmem = Ring<kLayout>::kStages *
                        stage_floats(Ring<kLayout>::kChunk, kChannels, kState) *
                        static_cast<int>(sizeof(float));
  auto kernel = selective_scan_kernel<kState, kLayout>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte copies need 16-byte aligned rows and whole 4-float groups at
  // the ragged edge of d
  const bool vec_ud = aligned16(u) && aligned16(dt) && dim % 4 == 0 &&
                      (us.b | us.t | dts.b | dts.t) % 4 == 0;
  const bool vec_bc = aligned16(bm) && aligned16(cm) &&
                      (bs.b | bs.t | cs.b | cs.t) % 4 == 0;
  const bool vec_h = aligned16(a) && aligned16(h0) && aligned16(h_out);
  const dim3 grid((dim + kChannels - 1) / kChannels, batch);
  kernel<<<grid, kThreads, kSmem, stream>>>(u, dt, bm, cm, a, h0, y, h_out,
                                            seq, dim, us, dts, bs, cs, vec_ud,
                                            vec_bc, vec_h);
  return static_cast<int>(cudaGetLastError());
}

template <int kState>
int launch_layout(int layout, const float* u, const float* dt,
                  const float* bm, const float* cm, const float* a,
                  const float* h0, float* y, float* h_out, int batch, int seq,
                  int dim, Strides us, Strides dts, Strides bs, Strides cs,
                  cudaStream_t stream) {
  switch (layout) {
    case 1:
      return launch<kState, 1>(u, dt, bm, cm, a, h0, y, h_out, batch, seq,
                               dim, us, dts, bs, cs, stream);
    case 2:
      return launch<kState, 2>(u, dt, bm, cm, a, h0, y, h_out, batch, seq,
                               dim, us, dts, bs, cs, stream);
    case 4:
      return launch<kState, 4>(u, dt, bm, cm, a, h0, y, h_out, batch, seq,
                               dim, us, dts, bs, cs, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Threads a channel for a scan over ``batch`` x ``dim`` channels of
// ``state`` states: the fewest of 1, 2, 4 that make kWaveThreads threads,
// else 4, which every N here splits into (mamba_scan.py's layout_for is the
// same rule).  ``state`` is taken for the C interface's sake.
int repro_selective_scan_layout_for(int batch, int dim, int state) {
  (void)state;
  const int64_t channels = static_cast<int64_t>(batch) * dim;
  for (int layout = 1; layout < 4; layout *= 2) {
    if (channels * layout >= kWaveThreads) return layout;
  }
  return 4;
}

// The scan on ``stream``, on the current device, with ``layout`` (1, 2 or
// 4) threads a channel.  Strides are in elements, for the batch and time
// dims of u, dt, Bm and Cm, whose last dim is contiguous; A, h0 and the
// outputs y (B, T, D) and hT (B, D, N) are contiguous.  batch, seq and
// dim > 0 are the caller's to ensure.  Returns the first CUDA error of the
// launch (0 == cudaSuccess), or cudaErrorInvalidValue for an N or a layout
// it does not take.
int repro_selective_scan_layout(const void* u, const void* dt,
                                const void* bm, const void* cm,
                                const void* a, const void* h0, void* y,
                                void* h_out, int batch, int seq, int dim,
                                int state, int64_t u_sb, int64_t u_st,
                                int64_t dt_sb, int64_t dt_st, int64_t b_sb,
                                int64_t b_st, int64_t c_sb, int64_t c_st,
                                int layout, void* stream) {
  const auto* uf = static_cast<const float*>(u);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cf = static_cast<const float*>(cm);
  const auto* af = static_cast<const float*>(a);
  const auto* hf = static_cast<const float*>(h0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(h_out);
  const Strides us{u_sb, u_st}, dts{dt_sb, dt_st}, bs{b_sb, b_st},
      cs{c_sb, c_st};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (state) {
    case 4:
      return launch_layout<4>(layout, uf, dtf, bf, cf, af, hf, yf, of, batch,
                              seq, dim, us, dts, bs, cs, st);
    case 8:
      return launch_layout<8>(layout, uf, dtf, bf, cf, af, hf, yf, of, batch,
                              seq, dim, us, dts, bs, cs, st);
    case 16:
      return launch_layout<16>(layout, uf, dtf, bf, cf, af, hf, yf, of,
                               batch, seq, dim, us, dts, bs, cs, st);
    case 32:
      return launch_layout<32>(layout, uf, dtf, bf, cf, af, hf, yf, of,
                               batch, seq, dim, us, dts, bs, cs, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The scan with the layout repro_selective_scan_layout_for picks; the same
// arguments as above without ``layout``.
int repro_selective_scan(const void* u, const void* dt, const void* bm,
                         const void* cm, const void* a, const void* h0,
                         void* y, void* h_out, int batch, int seq, int dim,
                         int state, int64_t u_sb, int64_t u_st,
                         int64_t dt_sb, int64_t dt_st, int64_t b_sb,
                         int64_t b_st, int64_t c_sb, int64_t c_st,
                         void* stream) {
  return repro_selective_scan_layout(
      u, dt, bm, cm, a, h0, y, h_out, batch, seq, dim, state, u_sb, u_st,
      dt_sb, dt_st, b_sb, b_st, c_sb, c_st,
      repro_selective_scan_layout_for(batch, dim, state), stream);
}

}  // extern "C"
