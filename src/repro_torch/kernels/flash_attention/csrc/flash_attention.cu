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
// g = H / Hkv.  Masked scores never enter the sums, the final divide is by
// max(l, 1e-30) as at flash_attention.py:71, and the output is written in
// the input type.  Query head h reads KV head h / g through the strides it
// is given, so no KV head is repeated or copied and q, k, v may be strided
// views (a slice of a KV cache) whose head dim is contiguous.  Tiles wholly
// above the diagonal or wholly before the window are never loaded, and a
// ragged T is masked, never padded.  The kernels do not synchronise and
// allocate nothing; the wrapper (flash_attention.py) owns the output.
//
// What bounds it on an H100: operations at long sequences, bytes and
// latency at short ones.  The causal work is 4 * B * H * hd FLOPs per kept
// (query, key) pair (QK^T and PV); at B=1, T=4096, H=40, hd=128 that is 172
// GFLOP, 0.17 ms at the 989 TFLOP/s of the bf16 tensor cores, while the
// bytes (q, k, v read once, o written once: 0.1 GB) take 0.03 ms.  At
// smollm-135m's serve shape (4 x 256 tokens, 9 heads of 64) the bound is
// ~1 us of bytes, and the time is set by the serial walk over the key tiles
// of the last query rows, behind the first loads.
//
// Two kernels, by input type:
//
// bf16 -> flash_fwd_wgmma_kernel, on the tensor cores.  One consumer
// warpgroup (128 threads) owns 64 query rows (wgmma's m64); a block holds
// one or two of them, and walks key tiles of 64 or 128 keys (launch_hd
// picks the shape per call).
//   * Q's tile is loaded once into shared memory; K and V tiles go through
//     a ring of 2 to 4 stages (as deep as two blocks a multiprocessor, or
//     one of two warpgroups, still fit), filled by 16-byte cp.async loads
//     (the strided views need no tensor map), so the next tiles are in
//     flight while this one is multiplied.  Rows past T are zero-filled by
//     cp.async's source size and masked at the store.
//   * The tiles are bf16 in the layout that the wgmma descriptors name:
//     rows of 128 bytes (64 bytes at hd = 32) with their 16-byte chunks
//     XOR-swizzled by row (128B, or 64B, swizzle), the head dim cut into
//     column blocks of 64.  Q and K are read K-major, V MN-major (the
//     transpose bit), so V needs no transpose in memory.
//   * S = Q K^T is wgmma m64n{64,128}k16, both operands from shared memory,
//     f32 accumulators in registers; products of bf16 values are exact in
//     f32, so S differs from the f32 upcast of the reference only in the
//     order of its sums.
//   * The online softmax stays in registers, in the accumulator's layout:
//     each thread owns two rows, and a row's max and sum are reduced over
//     its quad by shuffles.  exp2 with scale * log2(e) folded in; the
//     denominator l sums the f32 P.
//   * O += P V is wgmma m64n{hd}k16 with P converted to bf16 in registers
//     as its A operand: the f32 accumulator's fragment of S is the A
//     fragment of the next product.  That rounding of P to bf16 is the only
//     departure from f32 math (a relative 2^-9 on each weight; the tests
//     hold its result to the reference at half of 2.5e-2).
//   * Only the diagonal tile and the window's edge tile are masked element
//     by element.  Blocks are launched heaviest first (the last query rows,
//     which walk the most key tiles), so causal imbalance leaves no tail.
//   * O leaves through the warpgroup's rows of Q's tile in shared memory,
//     so that whole rows go out in 16-byte stores: stored straight from the
//     accumulator layout, 4 bytes a thread, they cost more than the math at
//     qwen3-14b's serve shape.
// It launches no library kernel.  What it does not do yet: a producer warp
// with TMA and warpgroups that alternate their softmax and their products
// (the step to the rest of the gap to the library call, PERF.md).
//
// f32 -> flash_fwd_kernel, on the CUDA cores.  TF32 tensor cores would not
// hold the f32 tolerance of 2e-5, and f32 attention serves only consistency
// checks, so it keeps the first port's design: one block per (64 query
// rows, head, batch), 256 threads, four per query row (float4 groups of the
// head dim interleaved across them, summed by two xor shuffles), K and V
// tiles of 32 keys staged in shared memory as f32, and an online softmax
// per row in registers.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Strides {  // in elements; the head dim is contiguous
  int64_t b, t, h;
};

// ------------------------------------------------- f32: CUDA-core kernel
constexpr int kRows = 64;                 // query rows per block
constexpr int kParts = 4;                 // threads per query row
constexpr int kThreads = kRows * kParts;  // 256
constexpr int kKeys = 32;                 // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int seq,
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
  const float* qrow =
      q + b * qs.b + static_cast<int64_t>(qpos) * qs.t + h * qs.h;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + kParts * i) + e;
      qr[4 * i + e] = active ? qrow[d] * scale : 0.0f;
      acc[4 * i + e] = 0.0f;
    }
  }
  float m = kNegInf;
  float l = 0.0f;

  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
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
        kv = kb[static_cast<int64_t>(kp) * ks.t + d];
        vv = vb[static_cast<int64_t>(kp) * vs.t + d];
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
    float* orow = o + ((static_cast<int64_t>(b) * seq + qpos) * heads + h) * HD;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        orow[4 * (part + kParts * i) + e] = acc[4 * i + e] / denom;
      }
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, int seq, int heads, int kv_heads, Strides qs,
               Strides ks, Strides vs, int window, float scale,
               cudaStream_t stream) {
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  flash_fwd_kernel<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), seq, heads,
      heads / kv_heads, qs, ks, vs, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------- bf16: tensor-core kernel
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kGroupRows = 64;      // query rows per warpgroup (wgmma m64)
constexpr int kGroupThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// A block: NWG consumer warpgroups over NWG x 64 query rows, key tiles of TN
// keys, and a ring of kStages (K, V) tile pairs in shared memory, as deep
// (up to 4) as the budget allows: 112 KiB keeps two one-warpgroup blocks
// on a multiprocessor (228 KiB, less 1 KiB reserved a block); a
// two-warpgroup block runs alone, as its registers need.
template <int HD, int NWG, int TN>
struct Config {
  static constexpr int kThreads = NWG * kGroupThreads;
  static constexpr int kRows = NWG * kGroupRows;
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kTileBytes = TN * HD * 2;  // one K or V tile
  static constexpr int kBudget = (NWG == 1 ? 112 : 226) * 1024;
  static constexpr int kFit = (kBudget - 1024 - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "the ring needs two stages");
  // Q, the ring, and slack to align the start to 1024 bytes
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;
};

// The shared-memory layout of a tile of `rows` rows of HD bf16 values: the
// head dim in column blocks of kRowBytes, each block rows x kRowBytes, the
// 16-byte chunks of a row XOR-swizzled by the row as wgmma's 128B (or 64B)
// swizzle mode reads them.  A tile starts on a 1024-byte boundary.
template <int HD>
struct Tile {
  static constexpr int kRowBytes = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks a row
  static constexpr int kSteps = kRowBytes / 32;   // k16 steps a column block
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 0x70 : 0x30;
  static constexpr uint64_t kMode = kRowBytes == 128 ? 1 : 2;  // 128B, 64B

  // byte offset of chunk c (8 values) of row r
  static __device__ __forceinline__ uint32_t offset(int rows, int r, int c) {
    const uint32_t off = (c / kChunks) * rows * kRowBytes + r * kRowBytes +
                         (c % kChunks) * 16;
    return off ^ ((off >> 3) & kSwizzle);
  }
};

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode in the top two bits.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | mode << 62;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  // src-size 0 zero-fills the 16 bytes: rows past T
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async
// proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous region
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 x;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}
// a barrier for the 128 threads of warpgroup wg alone (barrier 0 is
// __syncthreads')
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kGroupThreads)
               : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q K^T over one k16 step, Q (A) and K (B) K-major in shared memory:
// m64n64k16, 32 f32 accumulators a thread; scale_d == 0 starts the sum.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S = Q K^T over one k16 step, Q (A) and K (B) K-major in shared memory:
// m64n128k16, 64 f32 accumulators a thread; scale_d == 0 starts the sum.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += P V over one k16 step, P (A) in registers, V (B) MN-major in shared
// memory (the transpose bit): m64n32k16, 16 f32 accumulators a thread.
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over one k16 step, P (A) in registers, V (B) MN-major in shared
// memory (the transpose bit): m64n64k16, 32 f32 accumulators a thread.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over one k16 step, P (A) in registers, V (B) MN-major in shared
// memory (the transpose bit): m64n128k16, 64 f32 accumulators a thread.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// cp.async of rows row0 .. row0 + ROWS - 1 (zero past seq) of a strided
// (rows, HD) bf16 matrix into a Tile at dst, by THREADS threads
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int64_t stride, int row0, int seq,
                                          int tid) {
  constexpr int kPerRow = HD / 8;
  constexpr int kTotal = ROWS * kPerRow;
  static_assert(kTotal % THREADS == 0, "tile chunks must divide evenly");
#pragma unroll
  for (int i = 0; i < kTotal / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / kPerRow;
    const int c = e % kPerRow;
    const int row = row0 + r;
    const bool ok = row < seq;
    cp_async16(dst + Tile<HD>::offset(ROWS, r, c),
               src + static_cast<int64_t>(ok ? row : 0) * stride + c * 8, ok);
  }
}

template <int HD, int NWG, int TN>
__global__ void __launch_bounds__(NWG * kGroupThreads, 1)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int seq, int heads, int batch, int group, Strides qs,
                       Strides ks, Strides vs, int window, float scale_log2) {
  using C = Config<HD, NWG, TN>;
  using L = Tile<HD>;
  constexpr int kStages = C::kStages;
  constexpr uint32_t kSbo = 8 * L::kRowBytes;  // next 8 rows (K-major) or
                                               // next 8 keys (V, MN-major)
  extern __shared__ uint8_t smem[];
  const uint32_t sq =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023) & ~1023u;
  const uint32_t sk = sq + C::kQBytes;       // stage s: + s * kTileBytes
  const uint32_t sv = sk + kStages * C::kTileBytes;

  const int tid = threadIdx.x;
  const int wg = tid / kGroupThreads;
  const int warp = (tid % kGroupThreads) / 32;
  const int lane = tid % 32;
  // heaviest first: the block index runs over (head, batch) fastest and
  // over query tiles from the last one back
  const int bh = blockIdx.x % (heads * batch);
  const int h = bh % heads;
  const int b = bh / heads;
  const int n_qt = (seq + C::kRows - 1) / C::kRows;
  const int q0 =
      (n_qt - 1 - static_cast<int>(blockIdx.x) / (heads * batch)) * C::kRows;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + (h / group) * ks.h;
  const bf16* vb = v + b * vs.b + (h / group) * vs.h;

  // key tiles from the first one any row's window reaches to the one
  // holding the block's last row
  const int last = min(q0 + C::kRows, seq) - 1;
  const int first = window > 0 ? max(0, q0 - window + 1) / TN * TN : 0;
  const int n_kt = (last - first) / TN + 1;

  // every thread loads its share of key tile t into stage t % kStages, one
  // commit group per tile, an empty group past the last tile
  auto produce = [&](int t) {
    if (t < n_kt) {
      const uint32_t st = (t % kStages) * C::kTileBytes;
      load_tile<HD, TN, C::kThreads>(sk + st, kb, ks.t, first + t * TN, seq,
                                     tid);
      load_tile<HD, TN, C::kThreads>(sv + st, vb, vs.t, first + t * TN, seq,
                                     tid);
    }
    cp_async_commit();
  };
  // Q lands with tile 0; kStages - 1 tiles are kept in flight
  load_tile<HD, C::kRows, C::kThreads>(sq, qb, qs.t, q0, seq, tid);
  for (int t = 0; t < kStages - 1; ++t) produce(t);

  // this warpgroup's rows lo .. hi; this thread's two rows of the
  // accumulator layout (a, and b = a + 8) and its first column in each
  // 8-column block
  const int lo = q0 + wg * kGroupRows;
  const int hi = lo + kGroupRows - 1;
  const int row_a = lo + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int col = 2 * (lane % 4);
  const uint32_t sq_wg = sq + wg * kGroupRows * L::kRowBytes;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max (raw scores)
  float l_a = 0.0f, l_b = 0.0f;            // this thread's part of the sum
  float s[TN / 2];

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = first + j * TN;
    const uint32_t stage = (j % kStages) * C::kTileBytes;
    cp_async_wait<kStages - 2>();  // this thread's part of tile j
    fence_proxy_async();
    // tile j has landed for every thread, and every warpgroup is done with
    // tile j - 1, whose stage the next loads overwrite
    __syncthreads();
    produce(j + kStages - 1);
    // no row of this warpgroup sees a key of this tile (the warpgroup's
    // threads agree, as wgmma needs)
    if (k0 > hi || (window > 0 && k0 + TN - 1 <= lo - window)) continue;

    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // column block kk / kSteps, 32 bytes into the row per k16 step
      const uint32_t blk = kk / L::kSteps;
      const uint32_t step = (kk % L::kSteps) * 32;
      const uint64_t da = make_desc(
          sq_wg + blk * C::kRows * L::kRowBytes + step, 16, kSbo, L::kMode);
      const uint64_t db = make_desc(
          sk + stage + blk * TN * L::kRowBytes + step, 16, kSbo, L::kMode);
      wgmma_ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s[i]: row a for i % 4 < 2, else row b; key k0 + 8 (i / 4) + col + i % 2
    const bool edge = k0 + TN - 1 > lo || (window > 0 && hi - k0 >= window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) {
        const int kp = k0 + 8 * (i / 4) + col + (i % 2);
        const int qp = (i % 4) < 2 ? row_a : row_b;
        if (kp > qp || (window > 0 && qp - kp >= window)) s[i] = -INFINITY;
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) {
      if ((i % 4) < 2) {
        mx_a = fmaxf(mx_a, s[i]);
      } else {
        mx_b = fmaxf(mx_b, s[i]);
      }
    }
#pragma unroll
    for (int d = 1; d <= 2; d *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, d));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, d));
    }
    // the exponent's offset, finite for a row that has seen no key yet
    const float off_a = mx_a == -INFINITY ? 0.0f : mx_a * scale_log2;
    const float off_b = mx_b == -INFINITY ? 0.0f : mx_b * scale_log2;
    const float alpha_a = ex2(m_a * scale_log2 - off_a);
    const float alpha_b = ex2(m_b * scale_log2 - off_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) {
      if ((i % 4) < 2) {
        s[i] = ex2(fmaf(s[i], scale_log2, -off_a));
        sum_a += s[i];
      } else {
        s[i] = ex2(fmaf(s[i], scale_log2, -off_b));
        sum_b += s[i];
      }
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= (i % 4) < 2 ? alpha_a : alpha_b;
    // P in bf16 as wgmma's A fragments, one per 16 keys
    uint32_t pa[TN / 16][4];
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk) {
      // 16 keys further down V; the leading offset steps to the next 64
      // head dims (hd = 128)
      const uint64_t db = make_desc(sv + stage + kk * 16 * L::kRowBytes,
                                    TN * L::kRowBytes, kSbo, L::kMode);
      wgmma_rs(acc, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

#pragma unroll
  for (int d = 1; d <= 2; d *= 2) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, d);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, d);
  }
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  // O goes out through this warpgroup's rows of Q's tile (its last reader,
  // the final S product, is done), so that whole rows leave in coalesced
  // 16-byte stores: its rows are wg * 64 .. + 63 of the tile
  const int ra = warp * 16 + lane / 4;
  fence_proxy_async();  // wgmma read these bytes through the async proxy
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const uint32_t sub = 4 * (lane % 4);  // this thread's pair in the chunk
    st_shared(sq + L::offset(C::kRows, wg * kGroupRows + ra, n) + sub,
              pack_bf16(acc[4 * n + 0] * inv_a, acc[4 * n + 1] * inv_a));
    st_shared(sq + L::offset(C::kRows, wg * kGroupRows + ra + 8, n) + sub,
              pack_bf16(acc[4 * n + 2] * inv_b, acc[4 * n + 3] * inv_b));
  }
  group_sync(wg);
  constexpr int kPerRow = HD / 8;
#pragma unroll
  for (int i = 0; i < kGroupRows * kPerRow / kGroupThreads; ++i) {
    const int e = tid % kGroupThreads + i * kGroupThreads;
    const int r = e / kPerRow;
    const int c = e % kPerRow;
    const int row = lo + r;
    if (row < seq) {
      *reinterpret_cast<uint4*>(
          o + ((static_cast<int64_t>(b) * seq + row) * heads + h) * HD +
          8 * c) = ld_shared16(sq + L::offset(C::kRows, wg * kGroupRows + r,
                                              c));
    }
  }
}

template <int HD, int NWG, int TN>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq, int heads, int kv_heads, Strides qs, Strides ks,
           Strides vs, int window, float scale, cudaStream_t stream) {
  using C = Config<HD, NWG, TN>;
  const auto kernel = flash_fwd_wgmma_kernel<HD, NWG, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks =
      static_cast<int64_t>((seq + C::kRows - 1) / C::kRows) * heads * batch;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), seq, heads, batch,
      heads / kv_heads, qs, ks, vs, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The block shapes the library has: warpgroups x keys a tile; 128-key
// tiles take one warpgroup at hd 32 and 64, two at hd 128
enum class Shape { kOne64 = 0, kOne128 = 1, kTwo128 = 2 };

// The block shape for a call, from chip_smoke.py's timings of each shape on
// the H100 (PERF.md): two warpgroups sharing 128-key tiles pay off at
// hd = 128 from about a thousand tokens; 128-key tiles for one warpgroup
// halve the serial walk of a short prefill at hd 32 and 64, unless a
// narrow window would leave most of such a tile unread.
inline Shape pick(int hd, int seq, int window) {
  if (hd == 128) return seq >= 1024 ? Shape::kTwo128 : Shape::kOne64;
  return seq <= 512 && (window <= 0 || window >= 128) ? Shape::kOne128
                                                      : Shape::kOne64;
}

template <int HD>
int launch_hd(Shape shape, const void* q, const void* k, const void* v,
              void* o, int batch, int seq, int heads, int kv_heads,
              Strides qs, Strides ks, Strides vs, int window, float scale,
              cudaStream_t stream) {
  if (shape == Shape::kOne64) {
    return launch<HD, 1, 64>(q, k, v, o, batch, seq, heads, kv_heads, qs, ks,
                             vs, window, scale, stream);
  }
  if constexpr (HD == 128) {
    if (shape == Shape::kTwo128) {
      return launch<HD, 2, 128>(q, k, v, o, batch, seq, heads, kv_heads, qs,
                                ks, vs, window, scale, stream);
    }
  } else {
    if (shape == Shape::kOne128) {
      return launch<HD, 1, 128>(q, k, v, o, batch, seq, heads, kv_heads, qs,
                                ks, vs, window, scale, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// warpgroups, keys a tile, ring stages and dynamic shared memory (bytes) of
// a block of the given shape
template <int HD, int NWG, int TN>
void describe(int* out) {
  using C = Config<HD, NWG, TN>;
  out[0] = NWG;
  out[1] = TN;
  out[2] = C::kStages;
  out[3] = C::kSmem;
}

template <int HD>
int describe_hd(Shape shape, int* out) {
  if (shape == Shape::kOne64) {
    describe<HD, 1, 64>(out);
    return 0;
  }
  if constexpr (HD == 128) {
    if (shape == Shape::kTwo128) {
      describe<HD, 2, 128>(out);
      return 0;
    }
  } else {
    if (shape == Shape::kOne128) {
      describe<HD, 1, 128>(out);
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

template <int HD>
int launch_hd(int dtype, int shape, const void* q, const void* k,
              const void* v, void* o, int batch, int seq, int heads,
              int kv_heads, Strides qs, Strides ks, Strides vs, int window,
              float scale, cudaStream_t stream) {
  if (dtype == 0) {
    return launch_f32<HD>(q, k, v, o, batch, seq, heads, kv_heads, qs, ks,
                          vs, window, scale, stream);
  }
  if (dtype == 1 && shape >= -1 && shape <= 2) {
    return tc::launch_hd<HD>(
        shape < 0 ? tc::pick(HD, seq, window) : static_cast<tc::Shape>(shape),
        q, k, v, o, batch, seq, heads, kv_heads, qs, ks, vs, window, scale,
        stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The forward pass on ``stream``, on the current device.  dtype 0 is
// float32 (the CUDA-core kernel), 1 is bfloat16 (the tensor-core kernel,
// which needs 16-byte aligned pointers and strides that are multiples of 8
// elements); hd is 32, 64 or 128; window <= 0 means none.  Strides are in
// elements, for the batch, time and head dims of q, k and v; each head's hd
// values are contiguous.  o is a contiguous (B, T, H, hd) tensor of the same
// type.  batch, seq and heads > 0 are the caller's to ensure.  shape -1
// lets the launch pick the bf16 kernel's block; 0, 1 and 2 force one warpgroup
// with 64-key tiles, one with 128 (hd 32 and 64) or two with 128 (hd 128).
// Returns the first CUDA error of the launch (0 == cudaSuccess), or
// cudaErrorInvalidValue for a dtype, hd or shape it does not take.
int repro_flash_attention_fwd_block(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int seq, int heads, int kv_heads, int hd, int64_t q_sb,
    int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh, int window, float scale,
    int shape, void* stream) {
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_hd<32>(dtype, shape, q, k, v, o, batch, seq, heads,
                           kv_heads, qs, ks, vs, window, scale, s);
    case 64:
      return launch_hd<64>(dtype, shape, q, k, v, o, batch, seq, heads,
                           kv_heads, qs, ks, vs, window, scale, s);
    case 128:
      return launch_hd<128>(dtype, shape, q, k, v, o, batch, seq, heads,
                            kv_heads, qs, ks, vs, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forward pass with the block the launch picks: as
// repro_flash_attention_fwd_block with shape -1.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int batch, int seq,
                              int heads, int kv_heads, int hd, int64_t q_sb,
                              int64_t q_st, int64_t q_sh, int64_t k_sb,
                              int64_t k_st, int64_t k_sh, int64_t v_sb,
                              int64_t v_st, int64_t v_sh, int window,
                              float scale, void* stream) {
  return repro_flash_attention_fwd_block(
      q, k, v, o, dtype, batch, seq, heads, kv_heads, hd, q_sb, q_st, q_sh,
      k_sb, k_st, k_sh, v_sb, v_st, v_sh, window, scale, -1, stream);
}

// The bf16 kernel's block of the given shape (-1: the one the launch
// picks for a call of head dim hd over seq tokens): out[0..3] = warpgroups,
// keys a tile, ring stages, dynamic shared memory in bytes.  Returns
// cudaErrorInvalidValue for an hd or shape the library does not have.
int repro_flash_attention_block(int hd, int seq, int window, int shape,
                                int* out) {
  if (shape < -1 || shape > 2) return static_cast<int>(cudaErrorInvalidValue);
  const tc::Shape s = shape < 0 ? tc::pick(hd, seq, window)
                                : static_cast<tc::Shape>(shape);
  switch (hd) {
    case 32:
      return tc::describe_hd<32>(s, out);
    case 64:
      return tc::describe_hd<64>(s, out);
    case 128:
      return tc::describe_hd<128>(s, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
