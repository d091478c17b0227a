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
// The main path hands it one 4 MiB chunk a call, where the bytes alone take
// 1.25 us.  On an H100 a kernel that only reads a cold 4 MiB chunk from
// device memory already takes about 3.0 us, on this kernel's grid as on
// its first version's, and an empty launch of this grid 1.1 us
// (csrc/floor.cu's probes, timed by chip_checksum_ab.py --floor): latency
// and launch, not bytes, set the time there.  What a design can still cut is the work that follows the
// last load to land: the arithmetic and the reductions.
//
// What the design does:
// - Plan.  The host splits the words into a head (the 0-3 words before the
//   first 16-byte boundary), aligned 16-byte quads and a tail (0-3 words);
//   the head and tail go through scalar loads by block 0's first threads,
//   after its quads, so any 4-byte aligned pointer is taken and nothing is
//   padded.  ``plan_for`` is the one rule for the grid; checksum.py's
//   ``plan`` mirrors it and ``repro_fold_words_plan`` returns it.
// - Loads: blocks of 512 threads, each thread issuing kLoads independent
//   16-byte loads before it mixes any of them, over tiles of 512 x kLoads
//   quads.  While the input fits one wave of the card it is one quad a
//   thread (4 MiB: 512 blocks, 4 an SM, the whole chunk in flight at once
//   and the least arithmetic left after the last load); beyond it, four, in
//   a grid of one wave that strides over the rest.
// - Reduction: the block folds its threads with redux.sync and one shared
//   array, and makes one atomicXor into *acc (512 a call at 4 MiB; these
//   cost the launch a few tens of ns).
// Bulk asynchronous copies into a shared-memory ring, a fold through
// thread block clusters and a last-block ticket fold were each timed
// against this design on an H100 and were slower at 4 MiB and at 256 MiB
// (PERF.md).  XOR is associative and commutative, so the result is
// bit-exact whatever order the blocks finish in.  The kernel does not
// synchronise and allocates nothing; the wrapper (checksum.py) owns the
// accumulator.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPhi = 0x9E3779B1u;

constexpr int kThreads = 512;
constexpr int kLoadsBig = 4;         // quads a thread a tile beyond one wave
constexpr int kThreadsPerSm = 2048;
constexpr int kMaxDevices = 64;

// The plan of one call, in the order repro_fold_words_plan writes it and
// checksum.py's Plan reads it.
struct Plan {
  int64_t head;       // words before the first 16-byte boundary
  int64_t n_quads;    // 16-byte quads after the head
  int64_t tail;       // words after the quads
  int64_t threads;    // a block
  int64_t blocks;
  int64_t loads;      // quads a thread a tile
};
constexpr int kPlanFields = sizeof(Plan) / sizeof(int64_t);

// The one rule.  n_words > 0; ptr_mod_16 is the words' address mod 16 (a
// multiple of 4); sms the card's SM count.
Plan plan_for(int64_t n_words, int64_t ptr_mod_16, int64_t sms) {
  Plan p{};
  const int64_t lead = ((16 - ptr_mod_16) & 15) >> 2;
  p.head = n_words < lead ? n_words : lead;
  p.n_quads = (n_words - p.head) >> 2;
  p.tail = n_words - p.head - 4 * p.n_quads;
  p.threads = kThreads;
  const int64_t wave = sms * (kThreadsPerSm / kThreads);
  p.loads = p.n_quads <= wave * kThreads ? 1 : kLoadsBig;
  const int64_t tile = p.threads * p.loads;
  const int64_t want = (p.n_quads + tile - 1) / tile;
  p.blocks = want < 1 ? 1 : want < wave ? want : wave;
  return p;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// the fold of the four words of v, the first at global index i
__device__ __forceinline__ uint32_t mixed_quad(uint4 v, uint32_t i) {
  const uint32_t p = i * kPhi;
  return mix32(v.x ^ p) ^ mix32(v.y ^ (p + kPhi)) ^
         mix32(v.z ^ (p + 2u * kPhi)) ^ mix32(v.w ^ (p + 3u * kPhi));
}

// the head and tail words, one a thread of block 0's first threads
__device__ __forceinline__ uint32_t fold_edges(const uint32_t* words,
                                               const Plan& p, uint32_t start) {
  const int64_t t = threadIdx.x;
  if (blockIdx.x != 0 || t >= p.head + p.tail) return 0;
  const int64_t j = t < p.head ? t : p.head + 4 * p.n_quads + (t - p.head);
  return mix32(__ldg(words + j) ^ ((start + static_cast<uint32_t>(j)) * kPhi));
}

// Tiles of kThreads * kLoads quads, thread t taking quads t, t + kThreads,
// ... of a tile, all loads issued before any is used.  i0 is the global
// index of the first quad's first word.
template <int kLoads>
__device__ __forceinline__ uint32_t fold_quads(const uint4* __restrict__ quads,
                                               int64_t n_quads, uint32_t i0) {
  uint32_t h = 0;
  if (kLoads == 1) {
    // The plan takes one load a thread only while the input fits one wave,
    // so 32-bit indices hold it (4 * q wraps as the index does), and the
    // path from the kernel's entry to its one load is the shortest.
    const uint32_t n = static_cast<uint32_t>(n_quads);
    for (uint32_t q = blockIdx.x * kThreads + threadIdx.x; q < n;
         q += gridDim.x * kThreads) {
      h ^= mixed_quad(__ldg(quads + q), i0 + (q << 2));
    }
    return h;
  }
  constexpr int64_t kTile = int64_t{kThreads} * kLoads;
  for (int64_t base = blockIdx.x * kTile; base < n_quads;
       base += int64_t{gridDim.x} * kTile) {
    uint4 v[kLoads];
    if (base + kTile <= n_quads) {
#pragma unroll
      for (int k = 0; k < kLoads; ++k)
        v[k] = __ldg(quads + base + k * kThreads + threadIdx.x);
    } else {
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int64_t q = base + k * kThreads + threadIdx.x;
        v[k] = q < n_quads ? __ldg(quads + q) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int64_t q = base + k * kThreads + threadIdx.x;
      if (q < n_quads) h ^= mixed_quad(v[k], i0 + static_cast<uint32_t>(q << 2));
    }
  }
  return h;
}

template <int kLoads>
__global__ void __launch_bounds__(kThreads)
fold_words_kernel(const uint32_t* __restrict__ words, Plan p,
                  uint32_t start_word, uint32_t* __restrict__ acc) {
  const uint4* quads = reinterpret_cast<const uint4*>(words + p.head);
  uint32_t h = fold_quads<kLoads>(quads, p.n_quads,
                                  start_word + static_cast<uint32_t>(p.head));
  h ^= fold_edges(words, p, start_word);

  // the block's XOR into thread 0, then one atomic a block
  __shared__ uint32_t warp_h[kThreads / 32];
  h = __reduce_xor_sync(0xFFFFFFFFu, h);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_h[warp] = h;
  __syncthreads();
  if (warp == 0) {
    h = lane < kThreads / 32 ? warp_h[lane] : 0u;
    h = __reduce_xor_sync(0xFFFFFFFFu, h);
    if (lane == 0) atomicXor(acc, h);
  }
}

// Each device's SM count, queried once; 0 until then.  Threads that race
// on the first query store the same value.
std::atomic<int> g_sms[kMaxDevices];

cudaError_t device_sms(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = g_sms[device].load(std::memory_order_relaxed);
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    g_sms[device].store(*sms, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// XOR the fold of words[0:n_words] (global word offset start_word) into
// *acc on ``stream``, on the current device, by the plan's grid.  n_words >
// 0 is the caller's to ensure, and words 4-byte aligned.  Returns the first
// CUDA error of the query or the launch (0 == cudaSuccess).
int repro_fold_words(const void* words, int64_t n_words, uint32_t start_word,
                     void* acc, void* stream) {
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan_for(n_words, reinterpret_cast<uintptr_t>(words) & 15,
                          sms);
  const auto kernel = p.loads > 1 ? fold_words_kernel<kLoadsBig>
                                  : fold_words_kernel<1>;
  kernel<<<static_cast<unsigned>(p.blocks), static_cast<unsigned>(p.threads),
           0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), p, start_word,
      static_cast<uint32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

// The plan for n_words > 0 words at an address of ptr_mod_16 mod 16 on a
// card of ``sms`` SMs: kPlanFields int64 values into ``out`` (head,
// n_quads, tail, threads, blocks, loads).  Returns the number of fields
// written.
int repro_fold_words_plan(int64_t n_words, int64_t ptr_mod_16, int64_t sms,
                          int64_t* out) {
  const Plan p = plan_for(n_words, ptr_mod_16, sms);
  const int64_t* f = reinterpret_cast<const int64_t*>(&p);
  for (int i = 0; i < kPlanFields; ++i) out[i] = f[i];
  return kPlanFields;
}

}  // extern "C"
