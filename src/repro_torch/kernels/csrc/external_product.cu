// Blind-rotation external-product MAC for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/external_product.py::external_product_mac (body `_kernel`).
// For one BSK slice shared by the whole batch (the paper's key reuse):
//
//     out[b, k, f] = sum_j dig[b, j, f] * bsk[j, k, f]      (complex f64)
//
// Layouts are stacked re/im planes, as on the TPU:
//     dig (B, 2, J, F)    bsk (2, J, K, F)    out (B, 2, K, F)
// with J = (k+1) * pbs_level and F = N/2.
//
// Bound on the card: bytes.  At gpt2 and B = 12 (J = K = 2, F = 16,384)
// the call moves 13.6 MB and does 6.3 MFLOP, so it sits far below the
// FP64 ridge.  The design reads each BSK element once for the whole
// batch: one thread per f holds that f's J x K complex BSK values in
// registers and loops over b; every load and store is coalesced along f.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <int J, int K>
__global__ void __launch_bounds__(kThreads)
external_product_mac_kernel(const double* __restrict__ dig,
                            const double* __restrict__ bsk,
                            double* __restrict__ out, int B, int F) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  double wr[J][K], wi[J][K];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      wr[j][k] = bsk[((size_t)(0 * J + j) * K + k) * F + f];
      wi[j][k] = bsk[((size_t)(1 * J + j) * K + k) * F + f];
    }
  for (int b = 0; b < B; ++b) {
    const double* dr = dig + ((size_t)b * 2 + 0) * J * F + f;
    const double* di = dig + ((size_t)b * 2 + 1) * J * F + f;
    double xr[J], xi[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      xr[j] = dr[(size_t)j * F];
      xi[j] = di[(size_t)j * F];
    }
    double* orr = out + ((size_t)b * 2 + 0) * K * F + f;
    double* oi = out + ((size_t)b * 2 + 1) * K * F + f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double ar = 0.0, ai = 0.0;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        ar += xr[j] * wr[j][k] - xi[j] * wi[j][k];
        ai += xr[j] * wi[j][k] + xi[j] * wr[j][k];
      }
      orr[(size_t)k * F] = ar;
      oi[(size_t)k * F] = ai;
    }
  }
}

template <int J, int K>
void launch(const double* d, const double* w, double* o, int B, int F,
            cudaStream_t st) {
  external_product_mac_kernel<J, K>
      <<<(F + kThreads - 1) / kThreads, kThreads, 0, st>>>(d, w, o, B, F);
}

}  // namespace

extern "C" {

// dig (B, 2, J, F), bsk (2, J, K, F), out (B, 2, K, F): contiguous f64 on
// the current device.  J = K * level for K = k+1 in {1, 2, 3} and level in
// {1, 2, 3}; any other shape returns cudaErrorInvalidValue.
int external_product_mac_launch(const void* dig, const void* bsk, void* out,
                                int B, int J, int K, int F, void* stream) {
  auto d = static_cast<const double*>(dig);
  auto w = static_cast<const double*>(bsk);
  auto o = static_cast<double*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define EP_CASE(JJ, KK) \
  if (J == JJ && K == KK) { launch<JJ, KK>(d, w, o, B, F, st); return (int)cudaGetLastError(); }
  EP_CASE(1, 1) EP_CASE(2, 1) EP_CASE(3, 1)
  EP_CASE(2, 2) EP_CASE(4, 2) EP_CASE(6, 2)
  EP_CASE(3, 3) EP_CASE(6, 3) EP_CASE(9, 3)
#undef EP_CASE
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
