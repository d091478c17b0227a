// Causal flash attention forward, optionally sliding-window, with GQA.
//
// Replaces the Pallas TPU kernel ``_flash_kernel`` in
// src/repro/kernels/flash_attention/flash_attention.py (launched by
// flash_attention_pallas through pl.pallas_call, behind the GQA wrapper
// ops.py::flash_attention).  For q (B, T, H, hd) and k, v (B, T, Hkv, hd),
// H % Hkv == 0, it computes for every (b, t, h)
//
//     o[b,t,h] = sum_s softmax_s(q[b,t,h] . k[b,s,h/g] * hd^-1/2) v[b,s,h/g]
//
// over the keys s <= t (and t - s < window when a window is given), with
// g = H / Hkv.  The math is f32 for both input types, as the Pallas kernel
// and the reference upcast; the output is written in the input type.  Masked
// scores never enter the sums, and the final divide is by max(l, 1e-30) as
// at flash_attention.py:71.
//
// What bounds it on an H100: operations.  The causal work is about
// 2 * B * H * T^2 * hd multiply-adds' worth of FLOPs (QK^T and PV, each over
// half the T x T square); at B=1, T=4096, H=40, hd=128 that is 172 GFLOP,
// 0.17 ms at the 989 TFLOP/s of the bf16 tensor cores, while the bytes
// (q, k, v read once, o written once: 0.1 GB) take 0.03 ms.  This first
// kernel does its math in f32 on the CUDA cores (67 TFLOP/s at best, and
// each multiply-add also reads shared memory), so it runs many times above
// that bound; tensor cores (mma.sync / wgmma on bf16 tiles) are the next
// step.
//
// What the design does about it:
//   * one block per (query tile of 64 rows, head, batch), 256 threads: four
//     threads per query row.  Thread `part` of a row owns the head dims
//     4 * (part + 4 * i) .. + 3 (float4 groups interleaved across the four
//     threads), so a warp's shared-memory reads of a key row are 64
//     contiguous bytes broadcast to its eight rows, free of bank conflicts;
//   * the row's scaled query and its f32 accumulator live in registers; the
//     four partial dot products are summed by two xor shuffles;
//   * K and V tiles of 32 keys are staged in shared memory as f32 (32 KB at
//     hd = 128), shared by the block's 64 rows;
//   * the key loop runs from the first tile that any row's window reaches
//     to the tile holding the block's last row: tiles wholly above the
//     diagonal or wholly before the window are never loaded (the Pallas
//     kernel skipped only the former);
//   * online softmax per row (running max, denominator, rescaled
//     accumulator), one tile of 32 scores held in registers at a time;
//   * query head h reads KV head h / g through the strides it is given, so
//     no KV head is repeated or copied and q, k, v may be strided views (a
//     slice of a KV cache); the ragged last tile is masked, nothing is
//     padded.
// The kernel does not synchronise and allocates nothing; the wrapper
// (flash_attention.py) owns the output.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                 // query rows per block
constexpr int kParts = 4;                 // threads per query row
constexpr int kThreads = kRows * kParts;  // 256
constexpr int kKeys = 32;                 // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {  // in elements; the head dim is contiguous
  int64_t b, t, h;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq,
                 int heads, int group, Strides qs, Strides ks, Strides vs,
                 int window, float scale) {
  constexpr int kVec = HD / (4 * kParts);   // float4 groups per thread
  __shared__ __align__(16) float k_tile[kKeys][HD];
  __shared__ __align__(16) float v_tile[kKeys][HD];

  const int tid = threadIdx.x;
  const int row = tid / kParts;
  const int part = tid % kParts;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int qpos = q0 + row;
  const bool active = qpos < seq;

  float qr[4 * kVec];
  float acc[4 * kVec];
  const T* qrow = q + b * qs.b + static_cast<int64_t>(qpos) * qs.t + h * qs.h;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + kParts * i) + e;
      qr[4 * i + e] = active ? to_f32(qrow[d]) * scale : 0.0f;
      acc[4 * i + e] = 0.0f;
    }
  }
  float m = kNegInf;
  float l = 0.0f;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const int last = min(q0 + kRows, seq) - 1;
  const int first = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;

  for (int k0 = first; k0 <= last; k0 += kKeys) {
    __syncthreads();  // the previous tile has been read by every row
    for (int e = tid; e < kKeys * HD; e += kThreads) {
      const int c = e / HD;
      const int d = e % HD;
      const int kp = k0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (kp < seq) {
        kv = to_f32(kb[static_cast<int64_t>(kp) * ks.t + d]);
        vv = to_f32(vb[static_cast<int64_t>(kp) * vs.t + d]);
      }
      k_tile[c][d] = kv;
      v_tile[c][d] = vv;
    }
    __syncthreads();

    float s[kKeys];
    float m_cur = kNegInf;
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      const float4* kr = reinterpret_cast<const float4*>(k_tile[c]);
      float a = 0.0f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 kk = kr[part + kParts * i];
        a = fmaf(qr[4 * i + 0], kk.x, a);
        a = fmaf(qr[4 * i + 1], kk.y, a);
        a = fmaf(qr[4 * i + 2], kk.z, a);
        a = fmaf(qr[4 * i + 3], kk.w, a);
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      const int kp = k0 + c;
      const bool ok = kp <= qpos && (window <= 0 || qpos - kp < window);
      s[c] = ok ? a : kNegInf;
      m_cur = fmaxf(m_cur, s[c]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      const int kp = k0 + c;
      const bool ok = kp <= qpos && (window <= 0 || qpos - kp < window);
      s[c] = ok ? expf(s[c] - m_new) : 0.0f;
      psum += s[c];
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4 * kVec; ++i) acc[i] *= alpha;
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      const float4* vr = reinterpret_cast<const float4*>(v_tile[c]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 vv = vr[part + kParts * i];
        acc[4 * i + 0] = fmaf(s[c], vv.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(s[c], vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(s[c], vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(s[c], vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * seq + qpos) * heads + h) * HD;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store(orow + 4 * (part + kParts * i) + e, acc[4 * i + e] / denom);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq, int heads, int kv_heads, Strides qs, Strides ks,
           Strides vs, int window, float scale, cudaStream_t stream) {
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  flash_fwd_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, heads,
      heads / kv_heads, qs, ks, vs, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int batch, int seq, int heads, int kv_heads, Strides qs,
              Strides ks, Strides vs, int window, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, batch, seq, heads, kv_heads, qs, ks,
                           vs, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, batch, seq, heads, kv_heads, qs, ks,
                           vs, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, seq, heads, kv_heads, qs, ks,
                            vs, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The forward pass on ``stream``, on the current device.  dtype 0 is
// float32, 1 is bfloat16; hd is 32, 64 or 128; window <= 0 means none.
// Strides are in elements, for the batch, time and head dims of q, k and v;
// each head's hd values are contiguous.  o is a contiguous (B, T, H, hd)
// tensor of the same type.  batch, seq and heads > 0 are the caller's to
// ensure.  Returns the first CUDA error of the launch (0 == cudaSuccess), or
// cudaErrorInvalidValue for a dtype or hd it does not take.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int batch, int seq,
                              int heads, int kv_heads, int hd, int64_t q_sb,
                              int64_t q_st, int64_t q_sh, int64_t k_sb,
                              int64_t k_st, int64_t k_sh, int64_t v_sb,
                              int64_t v_st, int64_t v_sh, int window,
                              float scale, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_hd<float>(hd, q, k, v, o, batch, seq, heads, kv_heads, qs,
                            ks, vs, window, scale, s);
  }
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, batch, seq, heads,
                                    kv_heads, qs, ks, vs, window, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
