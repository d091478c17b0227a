// AdamW's elementwise work on the card: the gradients' global norm and the
// update, each a pass that reads every leaf once.
//
// Replaces no TPU kernel: the JAX package's AdamW is jnp
// (src/repro/optim/adamw.py update), which XLA fuses leaf by leaf.  As
// eager PyTorch (ref.py, the plain version) the same update takes ~23
// elementwise kernels and copies a slice of a leaf on the card, each an f32
// read and write, and the norm a cast, a square and a sum a leaf: ~220 B a
// parameter against the 28 B the update needs; on an H100 that was 34.8%
// of a deepseek-v2-lite-16b training step, at 10.85% of its roofline.
//
// What bounds both passes on an H100: bytes.  The update reads the gradient
// (bf16 or f32) and the f32 master, m and v, and writes master, m, v and
// the bf16 params: 28 B a parameter from a bf16 gradient, 79.5 GB a step at
// the train cell's 2.84 B parameters, 23.7 ms at 3.35 TB/s.  The norm reads
// the gradients once more (2 B a parameter, 1.7 ms).  The arithmetic is a
// few f32 operations an element.
//
// sum_squares_kernel<G> (G the gradient's type: bf16 or f32) sums one
// leaf's squares in f32 into one partial a block.  The grid is a fixed
// function of the leaf's size (norm_blocks: up to kNormSlots blocks),
// each thread walks it in a fixed stride and a block sums its threads in a
// fixed tree, so a leaf's partials are the same from run to run.
// sum_finish_kernel, one block, sums each leaf's kNormSlots partials (the
// slots a leaf's grid left unused hold zeros, which add nothing) in a fixed
// order into the leaf's sum, then the leaves' sums in leaf order into their
// total, as the plain version's Python sum adds them.  The f32 sum is in
// another order than torch.sum's, so the norm is the plain one's within
// f32 rounding of a sum of n terms (the tests allow a relative 1e-5).
//
// adamw_update_kernel<G> updates one leaf in place, in the eager order, each
// operation rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: no FMA contraction), with each constant the f32 rounding of
// the double that PyTorch's scalar operation converts:
//     g  = g * scale
//     m  = b1 m + (1 - b1) g
//     v  = b2 v + ((1 - b2) g) g
//     p  = p - lr (m / b1c / (sqrt(v / b2c) + eps) + wd p)
//     out = bf16(p), rounded to nearest even
// scale, lr, b1c and b2c are read from their 0-d f32 tensors on the card, so
// nothing waits for the host.  Given the same four scalars, the new master,
// m, v and bf16 params are the eager update's bit for bit.
//
// What the designs do about the bytes: a thread takes 8 elements at a time
// by 16-byte loads and stores (one of a bf16 gradient and of the bf16
// params, two of each f32 leaf) where every pointer of the leaf is 16-byte
// aligned; a ragged tail, and a whole leaf with a misaligned pointer, take
// the same kernel's scalar path.  No intermediate goes to device memory.
// No kernel synchronises or allocates; the wrapper (adamw.py) owns every
// output and scratch buffer.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;             // elements a thread takes at once
constexpr int kNormSlots = 1024;    // most blocks (partials) a leaf's norm
constexpr int kNormUnits = 4;       // 8-element units a norm thread takes
                                    // at least before the grid is capped
constexpr int kUpdateBlocks = 4096; // most blocks an update launch

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load8(const float* x, float (&f)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(x)[0];
  const float4 b = reinterpret_cast<const float4*>(x)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* x,
                                      float (&f)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(x);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(float* x, const float (&f)[kVec]) {
  reinterpret_cast<float4*>(x)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(x)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* x,
                                       const float (&f)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k)
    h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  *reinterpret_cast<uint4*>(x) = raw;
}

// a warp's sum, lane 0 holding it, in a fixed tree
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  return x;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
sum_squares_kernel(const G* __restrict__ x, int64_t n, int vec,
                   float* __restrict__ partials) {
  __shared__ float warps[kThreads / 32];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads
                        + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  float acc = 0.0f;
  int64_t done = 0;
  if (vec) {
    const int64_t units = n / kVec;
    for (int64_t u = first; u < units; u += stride) {
      float f[kVec];
      load8(x + u * kVec, f);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        acc = __fadd_rn(acc, __fmul_rn(f[k], f[k]));
    }
    done = units * kVec;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    const float f = to_f32(x[i]);
    acc = __fadd_rn(acc, __fmul_rn(f, f));
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, warps[w]);
    partials[blockIdx.x] = s;
  }
}

// out[l] = leaf l's kNormSlots partials summed; out[leaves] = the leaves'
// sums added in leaf order from 0
__global__ void __launch_bounds__(kThreads)
sum_finish_kernel(const float* __restrict__ partials, int leaves,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < leaves; l += kThreads / 32) {
    const float* slots = partials + static_cast<int64_t>(l) * kNormSlots;
    float acc = 0.0f;
    for (int s = lane; s < kNormSlots; s += 32)
      acc = __fadd_rn(acc, slots[s]);
    acc = warp_sum(acc);
    if (lane == 0) out[l] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int l = 0; l < leaves; ++l) total = __fadd_rn(total, out[l]);
    out[leaves] = total;
  }
}

// the f32 roundings of the update's constants: b1, 1 - b1, b2, 1 - b2, eps
// and the weight decay, each taken from the double in the host's order
struct Hyper {
  float b1, c1, b2, c2, eps, wd;
};

struct Scalars {
  float scale, lr, b1c, b2c;
};

// one element of the eager update, op for op
__device__ __forceinline__ void adamw_step(float g, float& p, float& m,
                                           float& v, const Scalars& s,
                                           const Hyper& h) {
  g = __fmul_rn(g, s.scale);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.c2, g), g));
  const float mh = __fdiv_rn(m, s.b1c);
  const float vh = __fdiv_rn(v, s.b2c);
  const float d = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps)),
                            __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, d));
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const G* __restrict__ g, float* __restrict__ p,
                    float* __restrict__ m, float* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int64_t n, int vec,
                    const float* __restrict__ scale,
                    const float* __restrict__ lr,
                    const float* __restrict__ b1c,
                    const float* __restrict__ b2c, Hyper h) {
  const Scalars s{*scale, *lr, *b1c, *b2c};
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads
                        + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t done = 0;
  if (vec) {
    const int64_t units = n / kVec;
    for (int64_t u = first; u < units; u += stride) {
      const int64_t i = u * kVec;
      float gf[kVec], pf[kVec], mf[kVec], vf[kVec];
      load8(g + i, gf);
      load8(p + i, pf);
      load8(m + i, mf);
      load8(v + i, vf);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        adamw_step(gf[k], pf[k], mf[k], vf[k], s, h);
      store8(p + i, pf);
      store8(m + i, mf);
      store8(v + i, vf);
      store8(out + i, pf);
    }
    done = units * kVec;
  }
  for (int64_t i = done + first; i < n; i += stride) {
    float pi = p[i], mi = m[i], vi = v[i];
    adamw_step(to_f32(g[i]), pi, mi, vi, s, h);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
    out[i] = __float2bfloat16_rn(pi);
  }
}

bool aligned(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the blocks (partials) of a leaf of n elements: a fixed function of n
int norm_blocks(int64_t n) {
  const int64_t want = ceil_div(n, int64_t{kThreads} * kVec * kNormUnits);
  return static_cast<int>(want < 1 ? 1 : (want > kNormSlots ? kNormSlots
                                                              : want));
}

}  // namespace

extern "C" {

// the partials a leaf takes in the norm's scratch buffer
int repro_adamw_norm_slots() { return kNormSlots; }

// x's squares summed into partials[0 .. norm_blocks(n)); x is
// bf16 (bf16 != 0) or f32, contiguous; n > 0
int repro_adamw_sum_squares(const void* x, int bf16, int64_t n,
                            float* partials, void* stream) {
  const int blocks = norm_blocks(n);
  const int vec = aligned(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    sum_squares_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, vec, partials);
  else
    sum_squares_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, vec, partials);
  return static_cast<int>(cudaGetLastError());
}

// partials: leaves x kNormSlots; out: leaves + 1
int repro_adamw_sum_finish(const float* partials, int leaves, float* out,
                           void* stream) {
  sum_finish_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, leaves, out);
  return static_cast<int>(cudaGetLastError());
}

// one leaf's update in place: g (bf16 != 0: bf16, else f32), p, m, v f32,
// out bf16, all contiguous of n > 0 elements; scale, lr, b1c, b2c 0-d f32
int repro_adamw_update(const void* g, int bf16, float* p, float* m, float* v,
                       void* out, int64_t n, const float* scale,
                       const float* lr, const float* b1c, const float* b2c,
                       float b1, float c1, float b2, float c2, float eps,
                       float wd, void* stream) {
  const Hyper h{b1, c1, b2, c2, eps, wd};
  const int vec = aligned(g) && aligned(p) && aligned(m) && aligned(v)
                  && aligned(out);
  // threads wanted: one an 8-element unit, or one an element of the tail
  const int64_t units = n / kVec, tail = n % kVec;
  const int64_t work = vec ? (units > tail ? units : tail) : n;
  const int64_t want = ceil_div(work, kThreads);
  const int blocks = static_cast<int>(want > kUpdateBlocks ? kUpdateBlocks
                                                           : want);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (bf16)
    adamw_update_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), p, m, v, o, n, vec, scale, lr,
        b1c, b2c, h);
  else
    adamw_update_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(g), p, m, v, o, n, vec, scale, lr, b1c,
        b2c, h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
