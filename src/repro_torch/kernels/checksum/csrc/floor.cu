// Floor probes for the integrity hash at the main path's 4 MiB chunk.
//
// Not part of the hash library: these kernels do less than the hash, so
// that their device times bound what one call of checksum.cu's kernel can
// cost on this card.  ``chip_checksum_ab.py --floor`` builds this file and
// times each probe on 32 rotating 4 MiB chunks (together beyond the 50 MB
// L2, as a cold chunk), on the grid the hash launches (``checksum.plan``)
// and on the grid of the kernel's first version.
//
//   kind 0  an empty kernel
//   kind 1  every 16-byte quad loaded once, one load a thread in a
//           grid-stride loop, the raw words XORed and one word a block
//           stored to out[blockIdx.x]: the hash without mix32 and its
//           atomics

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int kThreads>
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
load_kernel(const uint4* __restrict__ quads, uint32_t n_quads,
            uint32_t* __restrict__ out) {
  uint32_t h = 0;
  for (uint32_t q = blockIdx.x * kThreads + threadIdx.x; q < n_quads;
       q += gridDim.x * kThreads) {
    const uint4 v = __ldg(quads + q);
    h ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  __shared__ uint32_t warp_h[kThreads / 32];
  h = __reduce_xor_sync(0xFFFFFFFFu, h);
  if ((threadIdx.x & 31) == 0) warp_h[threadIdx.x >> 5] = h;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) h ^= warp_h[w];
    out[blockIdx.x] = h;
  }
}

template <int kThreads>
void launch(int kind, int blocks, const uint4* quads, uint32_t n_quads,
            uint32_t* out, cudaStream_t s) {
  if (kind == 0) empty_kernel<kThreads><<<blocks, kThreads, 0, s>>>();
  else load_kernel<kThreads><<<blocks, kThreads, 0, s>>>(quads, n_quads, out);
}

}  // namespace

extern "C" {

// Launch probe ``kind`` (0 or 1) as ``blocks`` blocks of ``threads`` (256
// or 512) threads over n_words words, 16-byte aligned and a multiple of 4
// (fewer than 2**34); ``out`` holds one word a block.  Returns the first
// CUDA error (0 == cudaSuccess).
int repro_floor(int kind, int threads, int blocks, const void* words,
                int64_t n_words, void* out, void* stream) {
  const uint4* quads = static_cast<const uint4*>(words);
  const uint32_t n_quads = static_cast<uint32_t>(n_words / 4);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((kind != 0 && kind != 1) || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (threads) {
    case 256: launch<256>(kind, blocks, quads, n_quads, o, s); break;
    case 512: launch<512>(kind, blocks, quads, n_quads, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
