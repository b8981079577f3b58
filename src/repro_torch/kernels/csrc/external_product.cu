// Blind-rotation external-product MAC for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/external_product.py::external_product_mac (body `_kernel`).
// For one BSK slice shared by the whole batch (the paper's key reuse):
//
//     out[b, k, f] = sum_j dig[b, j, f] * bsk[j, k, f]      (complex)
//
// Layouts are stacked re/im planes, as on the TPU:
//     dig (B, 2, J, F)    bsk (2, J, K, F)    out (B, 2, K, F)
// with J = (k+1) * pbs_level and F = N/2.
//
// Bound on the card: bytes.  At gpt2 (J = K = 2, F = 16,384) a call moves
// 13.6 MB at B = 12 and 303 MB at B = 288 against 8 B J K F flops, far
// below the FP64 ridge, so the design is about bytes in flight:
//  * a 2-D grid over (F tile, group of kRows rows): each thread holds its
//    f's J x K complex BSK values in registers and walks the group's rows,
//    so the 1.05 MB BSK slice is read once per row group (from L2 after
//    the first); the F tiles of one row group are adjacent in launch order;
//  * rows go two at a time: both rows' loads are issued before the first
//    store;
//  * the block shape (kThreads, kRows) is the best of
//    `kernels/mac_sweep.py` on the card at 12 and 288 rows, which builds
//    variants of this file with other values of the two constants.
// The sum over j keeps its order, so results match the plain einsum to
// rounding.
// Planes are f64 (the engine's path, `external_product_mac_launch`) or f32
// (the reference's default plane type, `external_product_mac_f32_launch`,
// which only `kernels.ops` reaches): the kernel is one template on the
// scalar, with the same (J, K) instantiations for both.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads per block, one f each
constexpr int kRows = 2;        // rows per block

template <class S, int J>
struct Row {
  S xr[J], xi[J];
  __device__ __forceinline__ void load(const S* dig, int b, int f, int F) {
    const S* dr = dig + (static_cast<size_t>(b) * 2 + 0) * J * F + f;
    const S* di = dig + (static_cast<size_t>(b) * 2 + 1) * J * F + f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      xr[j] = __ldg(dr + static_cast<size_t>(j) * F);
      xi[j] = __ldg(di + static_cast<size_t>(j) * F);
    }
  }
};

template <class S, int J, int K>
__device__ __forceinline__ void mac_store(const Row<S, J>& x, const S (&wr)[J][K],
                                          const S (&wi)[J][K], S* out,
                                          int b, int f, int F) {
  S* orr = out + (static_cast<size_t>(b) * 2 + 0) * K * F + f;
  S* oi = out + (static_cast<size_t>(b) * 2 + 1) * K * F + f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    S sr = 0, si = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      sr += x.xr[j] * wr[j][k] - x.xi[j] * wi[j][k];
      si += x.xr[j] * wi[j][k] + x.xi[j] * wr[j][k];
    }
    orr[static_cast<size_t>(k) * F] = sr;
    oi[static_cast<size_t>(k) * F] = si;
  }
}

template <class S, int J, int K>
__global__ void __launch_bounds__(kThreads)
external_product_mac_kernel(const S* __restrict__ dig,
                            const S* __restrict__ bsk,
                            S* __restrict__ out, int B, int F) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= F) return;
  const int b0 = blockIdx.y * kRows;
  const int b1 = min(B, b0 + kRows);
  S wr[J][K], wi[J][K];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      wr[j][k] = __ldg(bsk + (static_cast<size_t>(0 * J + j) * K + k) * F + f);
      wi[j][k] = __ldg(bsk + (static_cast<size_t>(1 * J + j) * K + k) * F + f);
    }
  int b = b0;
  for (; b + 1 < b1; b += 2) {
    Row<S, J> x0, x1;
    x0.load(dig, b, f, F);
    x1.load(dig, b + 1, f, F);
    mac_store<S, J, K>(x0, wr, wi, out, b, f, F);
    mac_store<S, J, K>(x1, wr, wi, out, b + 1, f, F);
  }
  if (b < b1) {
    Row<S, J> x0;
    x0.load(dig, b, f, F);
    mac_store<S, J, K>(x0, wr, wi, out, b, f, F);
  }
}

template <class S, int J, int K>
int launch(const S* d, const S* w, S* o, int B, int F, cudaStream_t st) {
  const dim3 grid((F + kThreads - 1) / kThreads, (B + kRows - 1) / kRows);
  external_product_mac_kernel<S, J, K><<<grid, kThreads, 0, st>>>(d, w, o, B, F);
  return static_cast<int>(cudaGetLastError());
}

// J = K * level for K = k+1 in {1, 2, 3} and level in {1, 2, 3}; any other
// shape returns cudaErrorInvalidValue.
template <class S>
int dispatch(const void* dig, const void* bsk, void* out, int B, int J, int K, int F,
             void* stream) {
  auto d = static_cast<const S*>(dig);
  auto w = static_cast<const S*>(bsk);
  auto o = static_cast<S*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define EP_CASE(JJ, KK) \
  if (J == JJ && K == KK) return launch<S, JJ, KK>(d, w, o, B, F, st);
  EP_CASE(1, 1) EP_CASE(2, 1) EP_CASE(3, 1)
  EP_CASE(2, 2) EP_CASE(4, 2) EP_CASE(6, 2)
  EP_CASE(3, 3) EP_CASE(6, 3) EP_CASE(9, 3)
#undef EP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dig (B, 2, J, F), bsk (2, J, K, F), out (B, 2, K, F): contiguous f64 on
// the current device, (J, K) as `dispatch` takes them.  B <= 2 * 65,535
// (row groups go on grid y): the Python wrapper slices larger batches.
int external_product_mac_launch(const void* dig, const void* bsk, void* out,
                                int B, int J, int K, int F, void* stream) {
  return dispatch<double>(dig, bsk, out, B, J, K, F, stream);
}

// The same on f32 planes.
int external_product_mac_f32_launch(const void* dig, const void* bsk, void* out,
                                    int B, int J, int K, int F, void* stream) {
  return dispatch<float>(dig, bsk, out, B, J, K, F, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
