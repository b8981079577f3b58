// Key-switch MAC for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/keyswitch.py::keyswitch_mac
// (body `_kernel`, 16-bit sub-limb product `_mul64`).  It computes
//
//     acc[b, t] = sum_s d[b, s] * K[s, t]   (mod 2^64)
//
// with d the int32 gadget digits (S = big_n * ks_level) and K the int64
// key-switching key; the caller forms (0, b) - acc.
//
// What differs from the TPU kernel:
//  * Hopper multiplies 64-bit integers natively, so the uint32-limb and
//    16-bit sub-limb synthesis is gone: products and sums are uint64 and
//    wrap mod 2^64, which is exactly the torus arithmetic.
//  * The TPU carried the sum across sequential grid steps.  Hopper blocks
//    run unordered, so S is split across blocks and the partial sums meet
//    in `atomicAdd` on unsigned long long.  Wrapping addition does not
//    depend on order, so the result is bit-exact whatever the schedule.
//  * The zero padding of S becomes a masked edge.
//
// Bound on the card: the KSK stream.  At the paper's gpt2 parameters K is
// 196,608 x 1,004 int64 = 1.58 GB, read once per round (0.47 ms at
// 3.35 TB/s), against 12 x 196,608 x 1,004 = 2.4 G 64-bit MACs.  So each
// block keeps the (at most 16) digit rows of its S range in shared memory
// and every thread holds one output column's sums for all of them in
// registers: each KSK element is read from device memory exactly once per
// round.  T is only 1,004 columns, so S is split to reach all 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // output columns per block
constexpr int kTileS = 256;     // digit rows staged in shared memory at once
constexpr int kRowsS = 1024;    // rows of S per block (split across blocks)

template <int MAXB>
__global__ void __launch_bounds__(kThreads)
keyswitch_mac_kernel(const int32_t* __restrict__ digits,
                     const unsigned long long* __restrict__ ksk,
                     unsigned long long* __restrict__ out,
                     int B, int S, int T) {
  __shared__ int32_t d_sh[MAXB][kTileS];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int b0 = blockIdx.z * MAXB;
  const int nb = min(MAXB, B - b0);
  const int s_begin = blockIdx.y * kRowsS;
  const int s_end = min(S, s_begin + kRowsS);

  unsigned long long acc[MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] = 0ull;

  for (int s0 = s_begin; s0 < s_end; s0 += kTileS) {
    const int ns = min(kTileS, s_end - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < MAXB * kTileS; i += kThreads) {
      const int b = i / kTileS, s = i % kTileS;
      d_sh[b][s] = (b < nb && s < ns)
          ? digits[(size_t)(b0 + b) * S + s0 + s] : 0;
    }
    __syncthreads();
    if (t < T) {
      const unsigned long long* kp = ksk + (size_t)s0 * T + t;
#pragma unroll 4
      for (int s = 0; s < ns; ++s) {
        const unsigned long long k = kp[(size_t)s * T];
#pragma unroll
        for (int b = 0; b < MAXB; ++b)
          acc[b] += (unsigned long long)(long long)d_sh[b][s] * k;
      }
    }
  }
  if (t < T) {
    for (int b = 0; b < nb; ++b)
      atomicAdd(out + (size_t)(b0 + b) * T + t, acc[b]);
  }
}

template <int MAXB>
void launch(const int32_t* d, const unsigned long long* k,
            unsigned long long* out, int B, int S, int T, cudaStream_t st) {
  dim3 grid((T + kThreads - 1) / kThreads, (S + kRowsS - 1) / kRowsS,
            (B + MAXB - 1) / MAXB);
  keyswitch_mac_kernel<MAXB><<<grid, kThreads, 0, st>>>(d, k, out, B, S, T);
}

}  // namespace

extern "C" {

// digits (B, S) int32, ksk (S, T) int64, out (B, T) int64 ZEROED by the
// caller; all contiguous on the current device.
int keyswitch_mac_launch(const void* digits, const void* ksk, void* out,
                         int B, int S, int T, void* stream) {
  auto d = static_cast<const int32_t*>(digits);
  auto k = static_cast<const unsigned long long*>(ksk);
  auto o = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // register-resident rows per block: the smallest of 4/8/12/16 >= B
  if (B <= 4) launch<4>(d, k, o, B, S, T, st);
  else if (B <= 8) launch<8>(d, k, o, B, S, T, st);
  else if (B <= 12) launch<12>(d, k, o, B, S, T, st);
  else launch<16>(d, k, o, B, S, T, st);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
