// Streaming integrity hash: XOR-fold of position-mixed uint32 words.
//
// Replaces the Pallas TPU kernel ``_checksum_kernel`` in
// src/repro/kernels/checksum/checksum.py (launched by checksum_words_pallas
// through pl.pallas_call).  For every word w[i], i < n_words, it computes
//
//     g[i] = mix32(w[i] ^ (uint32)(start_word + i) * 0x9E3779B1)
//
// and XORs all g[i] into *acc.  The global index wraps mod 2**32 exactly as
// the reference (ref.py fold_words_np) does, so files beyond 16 GiB and
// folds that start near 2**32 agree bit for bit.  The final
// mix32(acc ^ nbytes) runs on the host after the caller reads acc back, as
// the TPU path also finishes outside its kernel.
//
// What bounds it on an H100: bytes.  Each word is read once (4 bytes) and
// costs 12 32-bit integer operations (index add, index multiply, XOR, the
// eight of mix32, the accumulating XOR); at 3.35 TB/s the card delivers
// 8.4e11 words/s, which needs about 1.0e13 integer operations/s, below the
// card's 32-bit integer issue rate (132 SMs x 64 lanes x 1.98 GHz = 1.67e13/s).
//
// What the design does about it: the TPU kernel walked a sequential grid and
// carried its accumulator in VMEM from step to step.  Blocks on Hopper run in
// no order, so each thread keeps its own XOR in a register over a
// grid-stride loop, the block reduces with warp shuffles and one shared
// array, and each block makes a single atomicXor into the caller's device
// word.  XOR is associative and commutative, so the result is bit-exact
// whatever order the blocks finish in.  Where the words are 16-byte aligned
// each thread loads four words at once (uint4), the widest load a thread
// has; other pointers take scalar loads.  The tail is masked by n_words, so
// no padding is needed.  The kernel does not synchronise and allocates
// nothing; the wrapper (checksum.py) owns the accumulator.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr uint32_t kPhi = 0x9E3779B1u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t mixed(uint32_t w, uint32_t idx) {
  return mix32(w ^ (idx * kPhi));
}

__global__ void __launch_bounds__(kThreads)
fold_words_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                  uint32_t start_word, uint32_t* __restrict__ acc) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t h = 0;
  int64_t scalar_from = 0;
  if ((reinterpret_cast<uintptr_t>(words) & 15u) == 0) {
    const uint4* quads = reinterpret_cast<const uint4*>(words);
    const int64_t n_quads = n_words >> 2;
    for (int64_t q = tid; q < n_quads; q += stride) {
      const uint4 v = __ldg(quads + q);
      const uint32_t i = start_word + static_cast<uint32_t>(q << 2);
      h ^= mixed(v.x, i) ^ mixed(v.y, i + 1u) ^ mixed(v.z, i + 2u) ^
           mixed(v.w, i + 3u);
    }
    scalar_from = n_quads << 2;
  }
  for (int64_t j = scalar_from + tid; j < n_words; j += stride) {
    h ^= mixed(__ldg(words + j), start_word + static_cast<uint32_t>(j));
  }

  // warp, then block, XOR reduction; one atomic per block
  for (int off = 16; off > 0; off >>= 1) h ^= __shfl_xor_sync(0xFFFFFFFFu, h, off);
  __shared__ uint32_t warp_h[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_h[warp] = h;
  __syncthreads();
  if (warp == 0) {
    h = lane < kThreads / 32 ? warp_h[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) h ^= __shfl_xor_sync(0xFFFFFFFFu, h, off);
    if (lane == 0) atomicXor(acc, h);
  }
}

}  // namespace

extern "C" {

// XOR the fold of words[0:n_words] (global word offset start_word) into
// *acc on ``stream``, on the current device.  n_words > 0 is the caller's to
// ensure.  The grid covers the input at four words per thread, capped at
// kBlocksPerSm resident blocks per SM; larger inputs loop inside each thread.
// Returns the first CUDA error of the query or the launch (0 == cudaSuccess).
int repro_fold_words(const void* words, int64_t n_words, uint32_t start_word,
                     void* acc, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_block = int64_t{kThreads} * 4;
  const int64_t wanted = (n_words + per_block - 1) / per_block;
  const int blocks = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(wanted, int64_t{sms} * kBlocksPerSm)));
  fold_words_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, start_word,
      static_cast<uint32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
