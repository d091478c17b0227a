// Mamba1's single decode step (T == 1, a state given): the pointwise work
// around the GEMVs, in two kernels.
//
// Replaces no TPU kernel: the JAX package's single step (src/repro/models/
// ssm.py mamba1_block at T == 1) is jnp, which XLA fuses around its
// products.  On the card the same step as eager PyTorch took ~44 launches a
// layer (the conv's taps, casts, the f32 copy of dt_proj, exp(A_log), the
// recurrence, the gate), each a few microseconds at 16 rows, ~10 ms of a
// 16 ms falcon-mamba-7b step.  These two kernels take the step's pointwise
// work; the products in_x, in_z, x_proj and out_proj stay torch.matmul.
//
// mamba_conv_step_kernel<T> (T the activations' dtype: bf16 or f32), for xz
// (B, 1, C), the conv state (B, K-1, C), conv_w (K, C) and conv_b (C), all
// in T:
//     y  = ((0 + s_0 w_0) + s_1 w_1) + ... + x w_{K-1}, then + b      (f32)
//     xc = silu(float(T(y)))      written in f32 (what the gate reads) and
//                                 rounded to T (what x_proj reads)
//     new state = (s_1, ..., s_{K-2}, x)
// The taps are summed in the eager order, from zero, each product and sum
// rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction), so y, and
// the new state, which is a copy, are the eager step's bit for bit.
//
// mamba_state_step_kernel<T, N>, for dt_low (B, R), Bm, Cm (B, N) (x_proj's
// output as it lies, in T, or after Jamba's three RMSNorms, in f32),
// dt_proj (R, C) in T, dt_bias, D (C) and A_log (C, N) in f32 (bf16 once an
// optimizer step has cast them), xc (B, C) f32, z (B, C) in T and h
// (B, C, N) f32:
//     dt  = softplus(dt_low . dt_proj[:, c] + dt_bias[c])    f32 from the
//           bf16 weight (an exact widening: no f32 copy of dt_proj)
//     h_n = exp(dt * -exp(A_log[c, n])) h_n + (dt xc) Bm_n
//     y   = (sum_n Cm_n h_n + D[c] xc) silu(z)             rounded to T
// and writes y (B, C) in T and the new h (B, C, N) f32.
//
// What bounds them on an H100: bytes.  At falcon-mamba-7b's serve shape
// [B=16, C=8192, N=16, R=256] in bf16 a layer's state step reads dt_proj
// (4.19 MB), h (8.39 MB), A_log (0.52 MB), xc, z, dt_bias and D (0.85 MB)
// and writes h (8.39 MB) and y (0.26 MB): 22.6 MB, 6.8 us at 3.35 TB/s.
// The conv step moves 2.7 MB, 0.8 us.  Its 33.5 M multiply-adds (the dt
// product) and 2.1 M exps are a microsecond of the card's f32 and SFU
// rates.  What the design does about it:
//   * a block of the state step owns a tile of 16 rows x 32 channels.  It
//     first copies the tile's dt_proj columns into shared memory by
//     asynchronous 16-byte copies, so each byte of dt_proj is read from
//     device memory once a step for all 16 rows, and stages the tile's
//     dt_low, Bm and Cm rows there; its rows of R are split among 16 (bf16)
//     or 8 (f32) slices of the block, whose partial sums meet in shared
//     memory;
//   * 4 lanes own a (row, channel), each with N/4 of its states, so that a
//     warp's loads and stores of h are 8 x N x 4 contiguous bytes; a thread
//     keeps one channel (and A = -exp(A_log) of its states) for 8 rows, and
//     loads their states, xc and z into registers first, so that h's bytes
//     are in flight through the staging and the dt product; h is read and
//     written once, and no intermediate goes to device memory;
//   * the conv step is one thread a (row, channel), its loads and stores
//     coalesced along the channels.
// Sums other than the conv's are in another order than the eager step's
// cuBLAS products (the dt dot product, the C contraction): dt, h and y are
// the eager values within f32 rounding, which exp(dt * A) carries into h
// relatively by up to |dt A| (tens at falcon-mamba's A = -(1..16)).
// Neither kernel synchronises or allocates; the wrapper (mamba_step.py)
// owns every output.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 8;         // the conv widths the conv step takes
// the state step's tile: kRows batch rows by kChannels channels a block
constexpr int kRows = 16;
constexpr int kChannels = 32;
// a staged dt_low column: the tile's rows, padded to a 16-byte multiple
// that spreads the staging stores over the banks
constexpr int kDtPad = kRows + 4;
// devices a process may launch the state step on
constexpr int kMaxDevices = 64;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// element i of a tensor that is bf16 or f32, as told at run time
__device__ __forceinline__ float load_any(const void* p, int64_t i,
                                          bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// F.silu and F.softplus (beta 1, threshold 20) of PyTorch's CUDA kernels
__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplus(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_conv_step_kernel(const T* __restrict__ xz, const T* __restrict__ state,
                       const T* __restrict__ w, const T* __restrict__ bias,
                       float* __restrict__ xc, T* __restrict__ xc_act,
                       T* __restrict__ new_state, int batch, int dim,
                       int taps, int64_t xz_sb, int64_t st_sb,
                       int64_t st_sk) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(batch) * dim) return;
  const int64_t b = i / dim;
  const int c = static_cast<int>(i % dim);
  // the window is the state's K-1 rows, then x; its last K-1 entries are
  // the new state
  float y = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    if (k < taps) {
      const T v = k < taps - 1 ? state[b * st_sb + k * st_sk + c]
                               : xz[b * xz_sb + c];
      y = __fadd_rn(y, __fmul_rn(to_f32(v),
                                 to_f32(w[static_cast<int64_t>(k) * dim + c])));
      if (k > 0) new_state[(b * (taps - 1) + k - 1) * dim + c] = v;
    }
  }
  y = __fadd_rn(y, to_f32(bias[c]));
  const float v = silu(to_f32(from_f32<T>(y)));
  xc[i] = v;
  if constexpr (!std::is_same<T, float>::value) xc_act[i] = from_f32<T>(v);
}

// S states, in 16-byte pieces where ``vec`` (S a multiple of 4 and the
// address 16-byte aligned)
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

struct StepIn {                // what the state step reads besides T's
  const void* dt_low;          // (B, R), (B, N), (B, N): last dim contiguous
  const void* bm;
  const void* cm;
  int64_t dt_sb, b_sb, c_sb;   // their batch strides, in elements
  bool io_bf16;                // those three are bf16 (else f32)
  const void* dt_bias;         // (C,), (C, N), (C,) contiguous
  const void* a_log;
  const void* d_skip;
  bool par_bf16;               // those three are bf16 (else f32)
};

// the GEMV's geometry for T: channels a 16-byte piece of dt_proj holds,
// channel groups and row quads of a tile, and the slices of R
template <typename T>
struct Gemv {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kGroups = kChannels / kVec;
  static constexpr int kQuads = kRows / 4;
  static constexpr int kSlices = kThreads / (kGroups * kQuads);
};

// lanes a (row, channel): each holds N / kLanes of its states
constexpr int kLanes = 4;

// the state step's shared memory, in bytes from its start: the tile of
// dt_proj (R x kChannels in T), the staged dt_low (later the GEMV's partial
// sums), dt of each (row, channel), and the tile's Bm and Cm rows
template <typename T>
struct Staged {
  __host__ __device__ static constexpr int w_bytes(int rank) {
    return rank * kChannels * static_cast<int>(sizeof(T));
  }
  __host__ __device__ static constexpr int dt_floats(int rank) {
    return rank * kDtPad > Gemv<T>::kSlices * kRows * kChannels
               ? rank * kDtPad
               : Gemv<T>::kSlices * kRows * kChannels;
  }
  __host__ __device__ static constexpr int bytes(int rank, int state) {
    return w_bytes(rank) +
           4 * (dt_floats(rank) + kRows * kChannels + 2 * kRows * state);
  }
};

template <typename T, int kState>
__global__ void __launch_bounds__(kThreads)
mamba_state_step_kernel(StepIn in, const T* __restrict__ dt_proj,
                        const float* __restrict__ xc,
                        const T* __restrict__ z,
                        const float* __restrict__ h0, T* __restrict__ y,
                        float* __restrict__ h_out, int batch, int dim,
                        int rank, bool vec_w, bool vec_h) {
  using G = Gemv<T>;
  constexpr int kSub = kState / kLanes;          // states a lane
  constexpr int kGroupsPerPass = kThreads / kLanes;
  constexpr int kPairs = kRows * kChannels / kGroupsPerPass;
  constexpr int kRowStep = kGroupsPerPass / kChannels;
  extern __shared__ float4 smem4[];
  T* s_w = reinterpret_cast<T*>(smem4);
  float* s_dt = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + Staged<T>::w_bytes(rank));
  float* s_dtv = s_dt + Staged<T>::dt_floats(rank);   // [kRows][kChannels]
  float* s_b = s_dtv + kRows * kChannels;             // [kRows][kState]
  float* s_c = s_b + kRows * kState;

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kChannels;
  const int b0 = blockIdx.y * kRows;
  const int rows = min(kRows, batch - b0);

  // the tile of dt_proj first, by asynchronous 16-byte copies: the GEMV
  // waits on it alone
  if (vec_w) {
    constexpr int kPieces = kChannels / G::kVec;       // a row's pieces
    for (int e = tid; e < rank * kPieces; e += kThreads) {
      const int r = e / kPieces, col = (e % kPieces) * G::kVec;
      T* dst = s_w + r * kChannels + col;
      if (d0 + col < dim) {
        cp_async16(dst, dt_proj + static_cast<int64_t>(r) * dim + d0 + col);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int e = tid; e < rank * kChannels; e += kThreads) {
      const int r = e / kChannels, col = e % kChannels;
      s_w[e] = d0 + col < dim ? dt_proj[static_cast<int64_t>(r) * dim + d0 +
                                        col]
                              : from_f32<T>(0.0f);
    }
  }

  // this thread's channel and rows: kLanes lanes a (row, channel), a warp
  // on 8 neighbouring channels of a row, so that a warp's loads and stores
  // of h are 8 x N x 4 contiguous bytes.  Its operands are loaded now, so
  // that h's bytes are in flight through the staging and the GEMV
  const int sub = tid % kLanes;
  const int ch = (tid / kLanes) % kChannels;
  const int row0 = tid / kLanes / kChannels;
  const int d = d0 + ch;
  const bool live_d = d < dim;
  float h[kPairs][kSub], u[kPairs], zv[kPairs], a2[kSub];
  float dskip = 0.0f;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int row = row0 + k * kRowStep;
    u[k] = zv[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) h[k][j] = 0.0f;
    if (live_d && row < rows) {
      const int64_t bd = static_cast<int64_t>(b0 + row) * dim + d;
      load_states<kSub>(h[k], h0 + bd * kState + sub * kSub, vec_h);
      u[k] = xc[bd];
      zv[k] = to_f32(z[bd]);
    }
  }
  // A = -exp(A_log) of the lane's states
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    float a = 0.0f;
    if (live_d) {
      a = expf(load_any(in.a_log, static_cast<int64_t>(d) * kState +
                                      sub * kSub + j, in.par_bf16));
      // torch.exp of a bf16 tensor rounds its result to bf16
      if (in.par_bf16) a = __bfloat162float(__float2bfloat16_rn(a));
    }
    a2[j] = -a;
  }
  if (live_d) dskip = load_any(in.d_skip, d, in.par_bf16);

  // the tile's dt_low rows (as [r][row]), Bm and Cm rows; rows past the
  // batch are zeros
  for (int e = tid; e < kRows * rank; e += kThreads) {
    const int row = e / rank, r = e % rank;
    s_dt[r * kDtPad + row] =
        row < rows ? load_any(in.dt_low, (b0 + row) * in.dt_sb + r,
                              in.io_bf16)
                   : 0.0f;
  }
  for (int e = tid; e < kRows * kState; e += kThreads) {
    const int row = e / kState, n = e % kState;
    const bool live = row < rows;
    s_b[e] = live ? load_any(in.bm, (b0 + row) * in.b_sb + n, in.io_bf16)
                  : 0.0f;
    s_c[e] = live ? load_any(in.cm, (b0 + row) * in.c_sb + n, in.io_bf16)
                  : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  // dt_low . dt_proj: a thread sums kVec channels x 4 rows over the ranks
  // r = slice, slice + kSlices, ...; the slices' sums meet in s_dt
  {
    const int g = tid % G::kGroups;
    const int q = (tid / G::kGroups) % G::kQuads;
    const int slice = tid / (G::kGroups * G::kQuads);
    float acc[4][G::kVec];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < G::kVec; ++j) acc[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int r = slice; r < rank; r += G::kSlices) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(s_w + r * kChannels + g * G::kVec);
      const T* t = reinterpret_cast<const T*>(&raw);
      const float4 xr =
          *reinterpret_cast<const float4*>(s_dt + r * kDtPad + 4 * q);
      const float xv[4] = {xr.x, xr.y, xr.z, xr.w};
#pragma unroll
      for (int j = 0; j < G::kVec; ++j) {
        const float wv = to_f32(t[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(xv[i], wv, acc[i][j]);
      }
    }
    __syncthreads();   // every thread is done with dt_low's rows
    float* part = s_dt + (slice * kRows + 4 * q) * kChannels + g * G::kVec;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < G::kVec; j += 4) {
        *reinterpret_cast<float4*>(part + i * kChannels + j) = make_float4(
            acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      }
    }
  }
  __syncthreads();
  // dt of each (row, channel): the slices' sums, the bias, the softplus
  for (int e = tid; e < kRows * kChannels; e += kThreads) {
    const int c = e % kChannels;
    float dot = 0.0f;
#pragma unroll
    for (int s = 0; s < G::kSlices; ++s) dot += s_dt[s * kRows * kChannels + e];
    s_dtv[e] = d0 + c < dim
                   ? softplus(__fadd_rn(dot, load_any(in.dt_bias, d0 + c,
                                                      in.par_bf16)))
                   : 0.0f;
  }
  __syncthreads();

  // the recurrence and the gate of this thread's (row, channel) pairs: the
  // lane's states, then the C contraction summed over the channel's lanes
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int row = row0 + k * kRowStep;
    const bool live = live_d && row < rows;
    const float dt = s_dtv[row * kChannels + ch];
    const float dtu = __fmul_rn(dt, u[k]);
    const float* bn = s_b + row * kState + sub * kSub;
    const float* cn = s_c + row * kState + sub * kSub;
    float yv = 0.0f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const float a = expf(__fmul_rn(dt, a2[j]));
      h[k][j] = __fadd_rn(__fmul_rn(a, h[k][j]), __fmul_rn(dtu, bn[j]));
      yv = fmaf(h[k][j], cn[j], yv);
    }
    yv += __shfl_xor_sync(0xffffffffu, yv, 1);
    yv += __shfl_xor_sync(0xffffffffu, yv, 2);
    if (live) {
      const int64_t bd = static_cast<int64_t>(b0 + row) * dim + d;
      store_states<kSub>(h_out + bd * kState + sub * kSub, h[k], vec_h);
      if (sub == 0) {
        yv = __fadd_rn(yv, __fmul_rn(dskip, u[k]));
        y[bd] = from_f32<T>(__fmul_rn(yv, silu(zv[k])));
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch_conv(const void* xz, const void* state, const void* w,
                const void* b, void* xc, void* xc_act, void* new_state,
                int batch, int dim, int taps, int64_t xz_sb, int64_t st_sb,
                int64_t st_sk, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(batch) * dim;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  mamba_conv_step_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(
      static_cast<const T*>(xz), static_cast<const T*>(state),
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<float*>(xc), static_cast<T*>(xc_act),
      static_cast<T*>(new_state), batch, dim, taps, xz_sb, st_sb, st_sk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kState>
int launch_state(const StepIn& in, const void* dt_proj, const void* xc,
                 const void* z, const void* h0, void* y, void* h_out,
                 int batch, int dim, int rank, cudaStream_t stream) {
  const int smem = Staged<T>::bytes(rank, kState);
  auto kernel = mamba_state_step_kernel<T, kState>;
  // past 48 KB a kernel takes dynamic shared memory only when told, once a
  // device; a graph's warm-up tells it before its capture
  static int told[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (told[dev] < smem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      told[dev] = smem;
    }
  }
  // 16-byte copies of dt_proj need aligned rows: an aligned start and a
  // width of whole pieces
  const bool vec_w = aligned16(dt_proj) && dim % Gemv<T>::kVec == 0;
  const bool vec_h = aligned16(h0) && aligned16(h_out);
  const dim3 grid((dim + kChannels - 1) / kChannels,
                  (batch + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      in, static_cast<const T*>(dt_proj), static_cast<const float*>(xc),
      static_cast<const T*>(z), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_out), batch, dim, rank,
      vec_w, vec_h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_state_n(int state, const StepIn& in, const void* dt_proj,
                   const void* xc, const void* z, const void* h0, void* y,
                   void* h_out, int batch, int dim, int rank,
                   cudaStream_t stream) {
  switch (state) {
    case 4:
      return launch_state<T, 4>(in, dt_proj, xc, z, h0, y, h_out, batch, dim,
                                rank, stream);
    case 8:
      return launch_state<T, 8>(in, dt_proj, xc, z, h0, y, h_out, batch, dim,
                                rank, stream);
    case 16:
      return launch_state<T, 16>(in, dt_proj, xc, z, h0, y, h_out, batch,
                                 dim, rank, stream);
    case 32:
      return launch_state<T, 32>(in, dt_proj, xc, z, h0, y, h_out, batch,
                                 dim, rank, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The conv step on ``stream``, on the current device.  ``bf16`` says T:
// bf16 (1) or f32 (0), the dtype of xz, the state, conv_w, conv_b, xc_act
// and new_state.  xz is (B, 1, C) with batch stride xz_sb; the state (B,
// K-1, C) has strides st_sb, st_sk, its channels contiguous; conv_w (K, C),
// conv_b, and the outputs xc (B, 1, C) f32, xc_act (B, 1, C) (not written
// for f32, whose xc is xc_act) and new_state (B, K-1, C) are contiguous.
// batch, dim > 0 and 2 <= taps <= 8 are the caller's to ensure.  Returns
// the launch's CUDA error (0 == cudaSuccess).
int repro_mamba_conv_step(const void* xz, const void* state, const void* w,
                          const void* b, void* xc, void* xc_act,
                          void* new_state, int bf16, int batch, int dim,
                          int taps, int64_t xz_sb, int64_t st_sb,
                          int64_t st_sk, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_conv<__nv_bfloat16>(xz, state, w, b, xc, xc_act, new_state,
                                      batch, dim, taps, xz_sb, st_sb, st_sk,
                                      st);
  }
  return launch_conv<float>(xz, state, w, b, xc, xc_act, new_state, batch,
                            dim, taps, xz_sb, st_sb, st_sk, st);
}

// The selective-state step on ``stream``, on the current device.
// ``act_bf16`` says T (bf16 or f32), the dtype of dt_proj (R, C), z (B, 1,
// C) and y (B, 1, C); dt_low (B, R), Bm, Cm (B, N) are bf16 where
// ``io_bf16`` (else f32), with batch strides dt_sb, b_sb, c_sb and their
// last dim contiguous; dt_bias, A_log (C, N) and D are bf16 where
// ``par_bf16`` (else f32); xc (B, 1, C) and h0, h_out (B, C, N) are f32.
// All but dt_low, Bm and Cm are contiguous.  batch, dim, rank > 0 are the
// caller's to ensure.  Returns the launch's CUDA error (0 ==
// cudaSuccess), or cudaErrorInvalidValue for an N it does not take.
int repro_mamba_state_step(const void* dt_low, const void* bm,
                           const void* cm, int io_bf16, int64_t dt_sb,
                           int64_t b_sb, int64_t c_sb, const void* dt_proj,
                           const void* dt_bias, const void* a_log,
                           const void* d_skip, int par_bf16, const void* xc,
                           const void* z, const void* h0, void* y,
                           void* h_out, int act_bf16, int batch, int dim,
                           int state, int rank, void* stream) {
  const StepIn in{dt_low, bm,      cm,    dt_sb,  b_sb,          c_sb,
                  io_bf16 != 0, dt_bias, a_log, d_skip, par_bf16 != 0};
  const auto st = static_cast<cudaStream_t>(stream);
  if (act_bf16) {
    return launch_state_n<__nv_bfloat16>(state, in, dt_proj, xc, z, h0, y,
                                         h_out, batch, dim, rank, st);
  }
  return launch_state_n<float>(state, in, dt_proj, xc, z, h0, y, h_out,
                               batch, dim, rank, st);
}

}  // extern "C"
