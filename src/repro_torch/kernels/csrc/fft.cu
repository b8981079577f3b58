// Four-step negacyclic FFT for Hopper (sm_90a), f64.
//
// Replaces the Pallas TPU kernels repro/kernels/fourstep_fft.py::fft_forward
// and ::fft_inverse (bodies `_fwd_kernel`, `_inv_kernel`).
//
//   forward:  real (B, N) -> spectrum planes (B, 2, M), M = N/2:
//             v[j] = (x[j] + i x[j+M]) * exp(i pi j / N)        (fold+twist)
//             X[m] = sum_j v[j] exp(-2 pi i j m / M)            (natural order)
//   inverse:  planes (B, 2, M) -> real (B, N), the exact inverse.
//
// The natural spectrum order matters: the BSK planes are made by
// torch.fft (repro_torch.core.fft), so a permuted spectrum would multiply
// mismatched frequencies.
//
// The TPU kernel holds a whole row in VMEM and does the R x R and C x C
// DFTs as matrix products.  At N = 32,768 a row is 256 KB of f64 and the
// 128 x 128 complex DFT matrix another 256 KB: both exceed the 227 KB of
// shared memory a Hopper block may use.  So the four-step split
// M = R * C (R = C = 128 at M = 16,384) runs as two passes, with the
// sub-transforms done as radix-2 FFTs in shared memory (about 29x fewer
// flops than the DFT products):
//
//   column pass: for each column j2, the R-point FFT over j1 of
//                v[j1*C + j2] (fold+twist on load), times the twiddle
//                W_M^(m1*j2), stored to an intermediate Y[m1][j2];
//   row pass:    for each m1, the C-point FFT over j2 of Y[m1][.],
//                stored transposed: X[m1 + R*m2].
//
// The inverse runs the mirror image: the row pass (inverse C-point FFT,
// conjugate twiddle), then the column pass (inverse R-point FFT, 1/M,
// untwist, split into real and imaginary halves).  The intermediate
// (B * M complex, 6.3 MB at B = 24 rows of N = 32,768) stays in L2.
//
// Bound on the card: bytes.  A forward call at gpt2 (24 rows) reads
// 6.3 MB and writes 6.3 MB: 3.76 us at 3.35 TB/s, against about 27 MFLOP
// (under 1 us of FP64).  The 0.5 MB of tables serve every call of a round
// from L2 and are not counted.  The tables of roots
// (W_M^k, k < M) and of the twist are made once on the host in float64.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;   // complex values per block: 32 KB of shared memory

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 cconj(double2 a) {
  return make_double2(a.x, -a.y);
}

__device__ __forceinline__ int bitrev(int i, int log_n) {
  return (int)(__brev((unsigned)i) >> (32 - log_n));
}

// In-place radix-2 decimation-in-time FFTs of `ncols` interleaved
// sequences of length L = 2^log_l, held as s[i * ncols + c] with i in
// bit-reversed order on entry and natural order on exit.  Roots come from
// W[k] = exp(-2 pi i k / M); `inverse` conjugates them.
__device__ void fft_tile(double2* s, int log_l, int ncols,
                         const double2* __restrict__ W, int M, bool inverse) {
  const int L = 1 << log_l;
  const int n_bfly = (L >> 1) * ncols;
  for (int log_h = 0; log_h < log_l; ++log_h) {
    const int half = 1 << log_h;
    const int wstep = M >> (log_h + 1);           // W_len = W_M^(M/len)
    for (int p = threadIdx.x; p < n_bfly; p += blockDim.x) {
      const int c = p % ncols;
      const int q = p / ncols;
      const int k = q & (half - 1);
      const int i0 = ((q >> log_h) << (log_h + 1)) + k;
      double2 w = W[k * wstep];
      if (inverse) w = cconj(w);
      const double2 a = s[i0 * ncols + c];
      const double2 b = cmul(s[(i0 + half) * ncols + c], w);
      s[i0 * ncols + c] = make_double2(a.x + b.x, a.y + b.y);
      s[(i0 + half) * ncols + c] = make_double2(a.x - b.x, a.y - b.y);
    }
    __syncthreads();
  }
}

// Forward column pass.  grid (C / cols, B); block: columns [c0, c0+cols).
__global__ void __launch_bounds__(kThreads)
fwd_col(const double* __restrict__ x, double2* __restrict__ y,
        const double2* __restrict__ twist, const double2* __restrict__ W,
        int M, int log_r, int C, int cols) {
  extern __shared__ double2 s[];
  const int R = 1 << log_r;
  const int b = blockIdx.y, c0 = blockIdx.x * cols;
  const double* xb = x + (size_t)b * 2 * M;
  for (int i = threadIdx.x; i < R * cols; i += blockDim.x) {
    const int j1 = i / cols, c = i % cols;
    const int j = j1 * C + c0 + c;
    s[bitrev(j1, log_r) * cols + c] =
        cmul(make_double2(xb[j], xb[j + M]), twist[j]);
  }
  __syncthreads();
  fft_tile(s, log_r, cols, W, M, false);
  double2* yb = y + (size_t)b * M;
  for (int i = threadIdx.x; i < R * cols; i += blockDim.x) {
    const int m1 = i / cols, c = i % cols;
    const int j2 = c0 + c;
    yb[m1 * C + j2] = cmul(s[m1 * cols + c], W[m1 * j2]);   // m1*j2 < M
  }
}

// Forward row pass.  grid (R / rows, B); block: rows m1 in [r0, r0+rows).
__global__ void __launch_bounds__(kThreads)
fwd_row(const double2* __restrict__ y, double* __restrict__ out,
        const double2* __restrict__ W, int M, int R, int log_c, int rows) {
  extern __shared__ double2 s[];
  const int C = 1 << log_c;
  const int b = blockIdx.y, r0 = blockIdx.x * rows;
  const double2* yb = y + (size_t)b * M;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, j2 = i % C;
    s[bitrev(j2, log_c) * rows + r] = yb[(r0 + r) * C + j2];
  }
  __syncthreads();
  fft_tile(s, log_c, rows, W, M, false);
  double* ob = out + (size_t)b * 2 * M;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int m2 = i / rows, r = i % rows;
    const int m = r0 + r + R * m2;
    const double2 v = s[m2 * rows + r];
    ob[m] = v.x;
    ob[M + m] = v.y;
  }
}

// Inverse row pass.  grid (R / rows, B).
__global__ void __launch_bounds__(kThreads)
inv_row(const double* __restrict__ spec, double2* __restrict__ y,
        const double2* __restrict__ W, int M, int R, int log_c, int rows) {
  extern __shared__ double2 s[];
  const int C = 1 << log_c;
  const int b = blockIdx.y, r0 = blockIdx.x * rows;
  const double* sb = spec + (size_t)b * 2 * M;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int m2 = i / rows, r = i % rows;
    const int m = r0 + r + R * m2;
    s[bitrev(m2, log_c) * rows + r] = make_double2(sb[m], sb[M + m]);
  }
  __syncthreads();
  fft_tile(s, log_c, rows, W, M, true);
  double2* yb = y + (size_t)b * M;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, j2 = i % C;
    const int m1 = r0 + r;
    yb[m1 * C + j2] = cmul(s[j2 * rows + r], cconj(W[m1 * j2]));
  }
}

// Inverse column pass.  grid (C / cols, B).
__global__ void __launch_bounds__(kThreads)
inv_col(const double2* __restrict__ y, double* __restrict__ x,
        const double2* __restrict__ twist, const double2* __restrict__ W,
        int M, int log_r, int C, int cols) {
  extern __shared__ double2 s[];
  const int R = 1 << log_r;
  const int b = blockIdx.y, c0 = blockIdx.x * cols;
  const double2* yb = y + (size_t)b * M;
  for (int i = threadIdx.x; i < R * cols; i += blockDim.x) {
    const int m1 = i / cols, c = i % cols;
    s[bitrev(m1, log_r) * cols + c] = yb[m1 * C + c0 + c];
  }
  __syncthreads();
  fft_tile(s, log_r, cols, W, M, true);
  const double scale = 1.0 / (double)M;
  double* xb = x + (size_t)b * 2 * M;
  for (int i = threadIdx.x; i < R * cols; i += blockDim.x) {
    const int j1 = i / cols, c = i % cols;
    const int j = j1 * C + c0 + c;
    double2 v = s[j1 * cols + c];
    v = cmul(make_double2(v.x * scale, v.y * scale), cconj(twist[j]));
    xb[j] = v.x;
    xb[j + M] = v.y;
  }
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

bool shape_ok(int M, int R, int C) {
  return R >= 2 && C >= 2 && R * C == M && (R & (R - 1)) == 0 &&
         (C & (C - 1)) == 0 && R <= kTile && C <= kTile;
}

}  // namespace

extern "C" {

// x (B, N) f64, out (B, 2, M) f64, scratch (B, M) complex128, twist (M)
// complex128, roots (M) complex128 with roots[k] = exp(-2 pi i k / M);
// all contiguous on the current device; R * C = M, both powers of two.
int fft_forward_launch(const void* x, void* out, void* scratch,
                       const void* twist, const void* roots,
                       int B, int M, int R, int C, void* stream) {
  if (!shape_ok(M, R, C)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto W = static_cast<const double2*>(roots);
  auto y = static_cast<double2*>(scratch);
  const int cols = C < kTile / R ? C : kTile / R;
  const int rows = R < kTile / C ? R : kTile / C;
  fwd_col<<<dim3(C / cols, B), kThreads, R * cols * sizeof(double2), st>>>(
      static_cast<const double*>(x), y, static_cast<const double2*>(twist), W,
      M, log2i(R), C, cols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fwd_row<<<dim3(R / rows, B), kThreads, rows * C * sizeof(double2), st>>>(
      y, static_cast<double*>(out), W, M, R, log2i(C), rows);
  return (int)cudaGetLastError();
}

// spec (B, 2, M) f64 -> x (B, N) f64; the other arguments as above.
int fft_inverse_launch(const void* spec, void* x, void* scratch,
                       const void* twist, const void* roots,
                       int B, int M, int R, int C, void* stream) {
  if (!shape_ok(M, R, C)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto W = static_cast<const double2*>(roots);
  auto y = static_cast<double2*>(scratch);
  const int cols = C < kTile / R ? C : kTile / R;
  const int rows = R < kTile / C ? R : kTile / C;
  inv_row<<<dim3(R / rows, B), kThreads, rows * C * sizeof(double2), st>>>(
      static_cast<const double*>(spec), y, W, M, R, log2i(C), rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  inv_col<<<dim3(C / cols, B), kThreads, R * cols * sizeof(double2), st>>>(
      y, static_cast<double*>(x), static_cast<const double2*>(twist), W,
      M, log2i(R), C, cols);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
