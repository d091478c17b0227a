// Batched lane segment step: advance_segment over [lane, row] float64.
//
// Replaces the Pallas TPU kernel ``_lane_step_kernel`` in
// src/repro/kernels/lane_step/lane_step.py (launched by lane_step_pallas
// through pl.pallas_call).  For every element i < n it computes
//
//     need      = rate > 0 ? max(0, bound - bd) / rate : +inf
//     hit       = need <= t
//     adv       = hit ? need : t
//     t_left    = hit ? t - need : 0
//     new_bytes = hit ? bound : bd + rate * t
//     moved     = rate * adv
//
// bit for bit as the numpy reference (ref.py lane_segment_step_np, that is
// core/transport.py advance_segment) does:
//   * every product, sum, difference and quotient is written with the
//     round-to-nearest intrinsics __dmul_rn / __dadd_rn / __dsub_rn /
//     __ddiv_rn, which nvcc never contracts into a fused multiply-add.  The
//     library is built with nvcc's default -fmad=true; the intrinsics alone
//     keep bd + rate * t two roundings, as numpy's two ufuncs are;
//   * max(0, x) is numpy's np.maximum(0.0, x): x unless 0 > x, so NaN (and
//     -0.0) pass through, where CUDA's fmax(0.0, NaN) would give 0;
//   * a non-positive or NaN rate fails ``rate > 0`` and gives need = +inf;
//   * hit is one byte, 0 or 1, the storage of a torch.bool tensor.
//
// What bounds it on an H100: bytes.  Each element reads four doubles (32 B)
// and writes four doubles and one byte (33 B), 65 B in all; at 3.35 TB/s that
// is 5.2e10 elements/s.  The work is six fp64 operations per element (two
// subtractions, one division, two products, one sum) and four compares; an
// fp64 division is a reciprocal estimate plus Newton steps, about ten fp64
// instructions, so some 20 per element, 1.0e12/s at the bytes bound: 6% of
// the card's fp64 issue rate (132 SMs x 64 fp64 lanes x 1.98 GHz = 1.67e13
// instructions/s, 33.5 TFLOP/s counting a fused multiply-add as two).
//
// What the design does about it: the TPU kernel walked 8-lane blocks of
// inputs padded by its wrapper to (8, 128) tiles.  Here the arrays are flat
// and contiguous, each thread handles one element per step of a grid-stride
// loop, neighbouring threads touch neighbouring doubles (coalesced 8-byte
// loads and stores), and the tail is masked by n, so no padding is made or
// copied.  The kernel does not synchronise and allocates nothing; the
// wrapper (lane_step.py) owns the outputs.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
lane_step_kernel(const double* __restrict__ t, const double* __restrict__ bd,
                 const double* __restrict__ rate,
                 const double* __restrict__ bound, int64_t n,
                 double* __restrict__ t_left, double* __restrict__ new_bytes,
                 double* __restrict__ adv_out, double* __restrict__ moved,
                 uint8_t* __restrict__ hit_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const double ti = __ldg(t + i);
    const double b = __ldg(bd + i);
    const double r = __ldg(rate + i);
    const double bo = __ldg(bound + i);
    const double gap = __dsub_rn(bo, b);
    const double ahead = (0.0 > gap) ? 0.0 : gap;
    const double need = (r > 0.0) ? __ddiv_rn(ahead, r) : CUDART_INF;
    const bool hit = need <= ti;
    const double adv = hit ? need : ti;
    t_left[i] = hit ? __dsub_rn(ti, need) : 0.0;
    new_bytes[i] = hit ? bo : __dadd_rn(b, __dmul_rn(r, ti));
    adv_out[i] = adv;
    moved[i] = __dmul_rn(r, adv);
    hit_out[i] = hit ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// The segment step over n elements on ``stream``, on the current device.
// n > 0 is the caller's to ensure.  The grid covers the input at one element
// per thread, capped at kBlocksPerSm resident blocks per SM; larger inputs
// loop inside each thread.  Returns the first CUDA error of the query or the
// launch (0 == cudaSuccess).
int repro_lane_step(const void* t, const void* bd, const void* rate,
                    const void* bound, int64_t n, void* t_left,
                    void* new_bytes, void* adv, void* moved, void* hit,
                    void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t wanted = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(wanted, int64_t{sms} * kBlocksPerSm)));
  lane_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(t), static_cast<const double*>(bd),
      static_cast<const double*>(rate), static_cast<const double*>(bound), n,
      static_cast<double*>(t_left), static_cast<double*>(new_bytes),
      static_cast<double*>(adv), static_cast<double*>(moved),
      static_cast<uint8_t*>(hit));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
