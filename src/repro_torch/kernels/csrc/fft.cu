// Negacyclic FFT for Hopper (sm_90a), f64, one launch per transform.
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
// Two more entry points run one CMux step's glue inside the same device
// code, so a blind-rotation step is three launches (forward, MAC, inverse):
//
//   forward digits: src (B, K, N) int64 and shifts (B,) -> (B, 2, J, M)
//             planes, J = K * level, row j = u * level + l: the transform of
//             gadget digit l of  X^shift[b] * src[b, u] - src[b, u]
//             (negacyclic rotation as core.batch.rotate_batch, digits as
//             core.decompose.decompose), or of src[b, u] without shifts;
//             the MAC kernel's dig layout.
//   inverse torus:  planes (B, 2, K, M), the MAC kernel's output layout,
//             -> int64 (B, K, N): the inverse, rounded onto the torus as
//             core.torus.float_to_torus, plus acc (B, K, N) when given.
//
// Design.  A row at N = 32,768 is 256 KB of f64, more than the 227 KB of
// shared memory a block may use, and the TPU's 128 x 128 DFT matrix would
// take as much again.  The four-step split M = R * C (R = C = 128 at
// M = 16,384; R = 2^ceil(lg M / 2), as factor_m) runs in ONE launch on a
// thread-block cluster of P blocks per row (P = 8 for M >= 4096, else 1):
//
//   1. each block loads its C/P columns of the row (R * C/P values), with
//      the mode's prologue (fold, twist, rotate, decompose, or conjugate
//      for the inverse), into shared memory;
//   2. R-point FFTs down its columns, the last pass multiplying by the
//      four-step twiddle W_M^(m1 j2);
//   3. cluster barrier; each block gathers its R/P rows from its peers'
//      shared memory (distributed shared memory) into a buffer of its own,
//      and arrives at a second cluster barrier that it waits on only
//      before it exits;
//   4. C-point FFTs along its rows, and the mode's epilogue as it stores.
//
// No intermediate goes to device memory.  The sub-FFTs are Stockham
// autosort passes of radix 16 (a first pass of radix 2, 4 or 8 where lg L
// is not a multiple of 4): a thread holds one butterfly's 16 complex
// values in registers, so a 128-point FFT is two passes (8 x 16) with one
// barrier each instead of seven radix-2 stages.
// Roots come from two small tables (256 + 4M/256 entries) computed per
// block in shared memory with sincospi: exp(2 pi i e / 4M) is the product
// of one entry of each, which gives the twist and the four-step twiddles
// with no gather from device memory, and every sub-FFT root is one entry.
// The blind rotation adds n transforms' rounding to the accumulator, where
// it is PBS output noise, so the roots are held to a few ulp: a butterfly's
// 16 four-step twiddles are four lookups, each followed by a recurrence of
// at most three products (on an H100, one lookup each cost a quarter more
// time, and a recurrence over all 16 made a CMux step's error 1.3x
// torch.fft's and the PBS output noise visibly larger;
// kernels/cmux_accuracy.py measures the step against the exact product).
// Sizes are template parameters (one instantiation per lg M), so every
// index is shifts and masks.  Column and row buffers have a row stride of one more than their
// width, so strided accesses hit distinct banks; the gather reads each
// peer along runs of C/P consecutive values.  Every load a thread makes is
// issued before the tables are built, so the loads are in flight while the
// roots are computed.
//
// The inverse is the forward transform of the conjugated spectrum:
// ifft(X) = conj(fft(conj(X))) / M, with the untwist folded into the store.
//
// Bound on the card: bytes.  At gpt2 (24 rows of M = 16,384) a forward call
// reads 6.3 MB and writes 6.3 MB: 3.76 us at 3.35 TB/s, against about
// 27 MFLOP, under 1 us of FP64 even on the CUDA cores.  So FP64 tensor
// cores (DMMA / wgmma) would buy nothing and are not used.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum Mode { kFwdFloat = 0, kFwdDigits = 1, kInvFloat = 2, kInvTorus = 3 };

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

constexpr int kMaxRadix = 16;   // radix of the Stockham passes (8 or 16)
constexpr int kTwRun = 4;       // four-step twiddles per table lookup

struct Args {
  const void* in;       // x (B, N) f64 | src (B, K, N) int64 | planes f64
  const int64_t* aux;   // shifts (B,) for digits, acc (B, K, N) for torus, or null
  void* out;
  int J;                // rows per batch element (digit rows, or K for the inverse)
  int level, base_log;  // forward digits only
};

template <int LOG_M>
struct Cfg {
  static constexpr int M = 1 << LOG_M, N = 2 * M;
  static constexpr int R = 1 << ((LOG_M + 1) / 2), C = 1 << (LOG_M / 2);
  static constexpr int P = LOG_M >= 12 ? 8 : 1;  // blocks per cluster (row)
  static constexpr int RB = R / P, CB = C / P;   // rows / columns per block
  static constexpr int CS = CB + 1;              // column-buffer row stride
  static constexpr int E = M / P;                // values per block
  static constexpr int T = E / 8 < 32 ? 32 : (E / 8 > 512 ? 512 : E / 8);
  static constexpr int EPT = (E + T - 1) / T;    // values per thread
  static constexpr int GS = RB + 1;              // row-buffer row stride
  static constexpr int BUF = R * CS;             // >= C * GS, as R >= C
  static constexpr int GBUF = C * GS;
  static constexpr int TH = 4 * M < 256 ? 4 * M : 256;
  static constexpr int LO = 4 * M / TH;
  static constexpr size_t SMEM = (2 * BUF + GBUF + TH + LO) * sizeof(double2);
};

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 cconj(double2 a) { return make_double2(a.x, -a.y); }
__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 mul_mi(double2 a) {  // -i * a
  return make_double2(a.y, -a.x);
}

// The two halves of a cluster barrier, so that work can go on between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Natural-order DFT of RADIX values in registers: v[k] = sum_r v[r] W^(rk).
template <int RADIX>
__device__ __forceinline__ void dft(double2* v);

template <>
__device__ __forceinline__ void dft<2>(double2* v) {
  const double2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<4>(double2* v) {
  const double2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const double2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[2] = csub(t0, t2);
  v[1] = cadd(t1, t3);
  v[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void dft<8>(double2* v) {
  double2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  constexpr double c = 0.70710678118654752440;
  o[1] = make_double2(c * (o[1].x + o[1].y), c * (o[1].y - o[1].x));   // W8^1
  o[2] = mul_mi(o[2]);                                                 // W8^2
  o[3] = make_double2(c * (o[3].y - o[3].x), -c * (o[3].x + o[3].y));  // W8^3
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// 16 = 4 x 4: four DFT-4 down the stride-4 columns, the twiddles
// W16^(r2 k1), four DFT-4 across; out[k1 + 4 k2].
template <>
__device__ __forceinline__ void dft<16>(double2* v) {
  constexpr double c1 = 0.92387953251128673848, s1 = 0.38268343236508978178;
  constexpr double h = 0.70710678118654752440;
  double2 a[4][4];
#pragma unroll
  for (int r2 = 0; r2 < 4; ++r2) {
    double2 t[4] = {v[r2], v[4 + r2], v[8 + r2], v[12 + r2]};
    dft<4>(t);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) a[r2][k1] = t[k1];
  }
  a[1][1] = cmul(a[1][1], make_double2(c1, -s1));    // W16^1
  a[1][2] = cmul(a[1][2], make_double2(h, -h));      // W16^2
  a[1][3] = cmul(a[1][3], make_double2(s1, -c1));    // W16^3
  a[2][1] = cmul(a[2][1], make_double2(h, -h));      // W16^2
  a[2][2] = mul_mi(a[2][2]);                         // W16^4
  a[2][3] = cmul(a[2][3], make_double2(-h, -h));     // W16^6
  a[3][1] = cmul(a[3][1], make_double2(s1, -c1));    // W16^3
  a[3][2] = cmul(a[3][2], make_double2(-h, -h));     // W16^6
  a[3][3] = cmul(a[3][3], make_double2(-c1, s1));    // W16^9
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    double2 t[4] = {a[0][k1], a[1][k1], a[2][k1], a[3][k1]};
    dft<4>(t);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = t[k2];
  }
}

// exp(2 pi i e / 4M) for e in [0, 4M), from the two root tables.
template <class CF>
__device__ __forceinline__ double2 zroot(const double2* hi, const double2* lo, int e) {
  return cmul(hi[e / CF::LO], lo[e % CF::LO]);
}

// One Stockham pass over NSEQ interleaved sequences of length L, value i
// of sequence s at i * STRIDE + s; NS is the product of earlier radices.
// With TW, output r, row m1 = d + r * NS of column j2 = j2_0 + s, is
// multiplied by the four-step twiddle W_M^(m1 j2).
template <class CF, int L, int NSEQ, int STRIDE, int RADIX, int NS, bool TW>
__device__ __forceinline__ void stockham_pass(const double2* __restrict__ in,
                                              double2* __restrict__ out,
                                              const double2* hi, const double2* lo,
                                              int j2_0) {
  constexpr int NB = L / RADIX, TOTAL = NB * NSEQ;
#pragma unroll
  for (int it = 0; it < (TOTAL + CF::T - 1) / CF::T; ++it) {
    const int q = threadIdx.x + it * CF::T;
    if (TOTAL % CF::T != 0 && q >= TOTAL) break;
    const int s = q % NSEQ, jb = q / NSEQ, k = jb % NS;
    double2 v[RADIX];
#pragma unroll
    for (int r = 0; r < RADIX; ++r) v[r] = in[(jb + r * NB) * STRIDE + s];
    if (NS > 1) {
      // W^(k r), each a table entry: k r < NS * RADIX, so k r STEP < TH.
      constexpr int STEP = CF::TH / (NS * RADIX);
#pragma unroll
      for (int r = 1; r < RADIX; ++r) v[r] = cmul(v[r], cconj(hi[r * k * STEP]));
    }
    dft<RADIX>(v);
    const int d = (jb / NS) * NS * RADIX + k;
    if constexpr (TW) {
      // Every kTwRun-th twiddle from the tables (m1 j2 < R C = M), the
      // ones between by a recurrence of at most kTwRun - 1 products: a
      // recurrence over all of r grows its rounding with r.
      const int j2 = j2_0 + s;
      constexpr int RUN = RADIX < kTwRun ? RADIX : kTwRun;
      const double2 step = cconj(zroot<CF>(hi, lo, 4 * NS * j2));
#pragma unroll
      for (int r0 = 0; r0 < RADIX; r0 += RUN) {
        double2 w = cconj(zroot<CF>(hi, lo, 4 * (d + r0 * NS) * j2));
#pragma unroll
        for (int r = r0; r < r0 + RUN; ++r) {
          v[r] = cmul(v[r], w);
          if (r + 1 < r0 + RUN) w = cmul(w, step);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RADIX; ++r) out[(d + r * NS) * STRIDE + s] = v[r];
  }
}

// All passes of an L-point FFT, ping-ponging a -> b -> a ...; returns the
// buffer that holds the result.  The odd radix goes first, so the last pass,
// which applies the twiddle when TW, is of radix kMaxRadix wherever L allows.
template <class CF, int L, int NSEQ, int STRIDE, bool TW, int NS = 1>
__device__ double2* fft_passes(double2* a, double2* b, const double2* hi,
                               const double2* lo, int j2_0) {
  if constexpr (NS >= L) {
    return a;
  } else {
    constexpr int LG_MAX = kMaxRadix == 16 ? 4 : 3;
    constexpr int LG_REM = ilog2(L / NS) % LG_MAX;
    constexpr int RADIX = LG_REM == 0 ? kMaxRadix : 1 << LG_REM;
    stockham_pass<CF, L, NSEQ, STRIDE, RADIX, NS, TW && NS * RADIX == L>(a, b, hi, lo,
                                                                        j2_0);
    __syncthreads();
    return fft_passes<CF, L, NSEQ, STRIDE, TW, NS * RADIX>(b, a, hi, lo, j2_0);
  }
}

// Signed gadget digit `l` (0 = most significant) of torus value v, as
// core.decompose.decompose: rounding by a logical shift, the carry
// rippling up from the least significant level.
__device__ __forceinline__ int64_t gadget_digit(uint64_t v, int base_log, int level,
                                                int l) {
  const int shift = 64 - base_log * level;
  uint64_t u = shift > 0 ? (v + (1ull << (shift - 1))) >> shift : v;
  const int64_t base = 1ll << base_log;
  int64_t carry = 0, digit = 0;
  for (int it = 0; it < level; ++it) {
    const int64_t raw = (int64_t)(u & (uint64_t)(base - 1)) + carry;
    u >>= base_log;
    carry = raw >= (base >> 1);
    const int64_t d = carry ? raw - base : raw;
    if (it == level - 1 - l) digit = d;
  }
  return digit;
}

// core.torus.float_to_torus: hi = rint(x / 2^32), lo = x - hi * 2^32 (both
// exact), then hi * 2^32 + rint(lo) wrapping mod 2^64; rint rounds half to
// even as torch.round does.
__device__ __forceinline__ uint64_t to_torus(double x) {
  const double hi = rint(x * 0x1p-32);
  const double lo = x - hi * 0x1p32;
  return (uint64_t)(long long)hi * 4294967296ull + (uint64_t)(long long)rint(lo);
}

template <int LOG_M, int MODE>
__global__ void __launch_bounds__(Cfg<LOG_M>::T, Cfg<LOG_M>::T <= 256 ? 2 : 1)
fft_kernel(Args a) {
  using CF = Cfg<LOG_M>;
  constexpr int M = CF::M, N = CF::N, R = CF::R, RB = CF::RB, CB = CF::CB;
  constexpr int CS = CF::CS, GS = CF::GS, E = CF::E, T = CF::T, EPT = CF::EPT;
  constexpr bool kForward = MODE == kFwdFloat || MODE == kFwdDigits;
  extern __shared__ double2 smem[];
  double2* buf0 = smem;
  double2* buf1 = smem + CF::BUF;
  double2* G = smem + 2 * CF::BUF;     // the gathered rows
  double2* hi = G + CF::GBUF;
  double2* lo = hi + CF::TH;
  cg::cluster_group cluster = cg::this_cluster();
  const int p = blockIdx.x;        // rank in the cluster: gridDim.x == P
  const int row = blockIdx.y;
  const int b = row / a.J, jj = row % a.J;

  // 1. Issue every load of this block's column slab, j = j1 * C + p * CB + c.
  double lre[EPT], lim[EPT];       // float modes
  uint64_t ls[EPT][2], lt[EPT][2];  // digits: src at j, j + M, and rotated
  const double* pre = nullptr;
  const double* pim = nullptr;
  const uint64_t* src = nullptr;
  int64_t shift = 0;
  if (MODE == kFwdFloat) {
    pre = static_cast<const double*>(a.in) + (size_t)row * N;
    pim = pre + M;
  } else if (MODE == kFwdDigits) {
    src = static_cast<const uint64_t*>(a.in) + ((size_t)b * (a.J / a.level) + jj / a.level) * N;
    if (a.aux != nullptr) shift = a.aux[b];
  } else {
    pre = static_cast<const double*>(a.in) + ((size_t)b * 2 * a.J + jj) * M;
    pim = pre + (size_t)a.J * M;
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = threadIdx.x + i * T;
    if (E % T != 0 && e >= E) break;
    const int j = (e / CB) * CF::C + p * CB + e % CB;
    if (MODE == kFwdDigits) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = j + h * M;
        ls[i][h] = src[pos];
        if (a.aux != nullptr) lt[i][h] = src[(int)((pos - shift) & (2 * N - 1)) & (N - 1)];
      }
    } else {
      lre[i] = pre[j];
      lim[i] = pim[j];
    }
  }

  // 2. Root tables: hi[t] = exp(2 pi i t / TH), lo[t] = exp(2 pi i t / 4M).
  for (int t = threadIdx.x; t < CF::TH + CF::LO; t += T) {
    double s, c;
    if (t < CF::TH) sincospi(2.0 * t / CF::TH, &s, &c);
    else sincospi(2.0 * (t - CF::TH) / (4 * M), &s, &c);
    hi[t] = make_double2(c, s);
  }
  __syncthreads();

  // 3. Prologue into the column buffer: value j1 of column c at j1 * CS + c.
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = threadIdx.x + i * T;
    if (E % T != 0 && e >= E) break;
    const int c = e % CB, j1 = e / CB;
    const int j = j1 * CF::C + p * CB + c;
    double2 z;
    if (MODE == kFwdDigits) {
      double d[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint64_t v = ls[i][h];
        if (a.aux != nullptr) {
          const int idx = (int)((j + h * M - shift) & (2 * N - 1));
          const uint64_t t = idx >= N ? 0ull - lt[i][h] : lt[i][h];
          v = t - v;
        }
        d[h] = (double)gadget_digit(v, a.base_log, a.level, jj % a.level);
      }
      z = cmul(make_double2(d[0], d[1]), zroot<CF>(hi, lo, j));
    } else if (kForward) {
      z = cmul(make_double2(lre[i], lim[i]), zroot<CF>(hi, lo, j));
    } else {
      z = make_double2(lre[i], -lim[i]);   // conj: ifft via the forward FFT
    }
    buf0[j1 * CS + c] = z;
  }
  __syncthreads();

  // 4. R-point FFTs down the columns, the last pass times W_M^(m1 j2).
  double2* F = fft_passes<CF, R, CB, CS, true>(buf0, buf1, hi, lo, p * CB);
  double2* X = F == buf0 ? buf1 : buf0;
  cluster.sync();

  // 5. Gather rows m1 = p * RB + rr from the peers: peer q holds columns
  // j2 = q * CB + c.  Consecutive threads read consecutive columns, a run
  // of CB values in the peer; all remote loads go first, so each thread
  // has EPT of them in flight.  F is left alone from here on, so the
  // peers' reads of it need no barrier until this block exits.
  double2 g[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = threadIdx.x + i * T;
    if (E % T != 0 && e >= E) break;
    const int c = e % CB, rr = (e / CB) % RB, q = e / (CB * RB);
    g[i] = cluster.map_shared_rank(F, q)[(p * RB + rr) * CS + c];
  }
  cluster_arrive();
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = threadIdx.x + i * T;
    if (E % T != 0 && e >= E) break;
    const int c = e % CB, rr = (e / CB) % RB, q = e / (CB * RB);
    G[(q * CB + c) * GS + rr] = g[i];
  }
  __syncthreads();

  // The torus epilogue's acc values, in flight during the row FFTs.
  uint64_t lacc[EPT][2];
  if (MODE == kInvTorus && a.aux != nullptr) {
    const uint64_t* acc = reinterpret_cast<const uint64_t*>(a.aux) + (size_t)row * N;
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = threadIdx.x + i * T;
      if (E % T != 0 && e >= E) break;
      const int m = p * RB + e % RB + R * (e / RB);
      lacc[i][0] = acc[m];
      lacc[i][1] = acc[m + M];
    }
  }

  // 6. C-point FFTs along the rows, in G and X; X[m1 + R * m2] at m2 * GS + r.
  const double2* H = fft_passes<CF, CF::C, RB, GS, false>(G, X, hi, lo, 0);

  // 7. Epilogue.
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = threadIdx.x + i * T;
    if (E % T != 0 && e >= E) break;
    const int r = e % RB, m2 = e / RB;
    const int m = p * RB + r + R * m2;
    const double2 y = H[m2 * GS + r];
    if (kForward) {
      double* ore = static_cast<double*>(a.out) + ((size_t)b * 2 * a.J + jj) * M;
      ore[m] = y.x;
      ore[(size_t)a.J * M + m] = y.y;
    } else {
      const double2 w = cmul(y, zroot<CF>(hi, lo, m));   // conj(w) / M is the value
      const double x0 = w.x * (1.0 / M), x1 = -w.y * (1.0 / M);
      if (MODE == kInvFloat) {
        double* o = static_cast<double*>(a.out) + (size_t)row * N;
        o[m] = x0;
        o[m + M] = x1;
      } else {
        uint64_t* o = static_cast<uint64_t*>(a.out) + (size_t)row * N;
        uint64_t t0 = to_torus(x0), t1 = to_torus(x1);
        if (a.aux != nullptr) {
          t0 += lacc[i][0];
          t1 += lacc[i][1];
        }
        o[m] = t0;
        o[m + M] = t1;
      }
    }
  }
  cluster_wait();   // the peers are done reading this block's F
}

template <int LOG_M, int MODE>
cudaError_t launch_one(const Args& a, int rows, cudaStream_t st) {
  using CF = Cfg<LOG_M>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(fft_kernel<LOG_M, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)CF::SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CF::P, rows, 1);
  cfg.blockDim = dim3(CF::T, 1, 1);
  cfg.dynamicSmemBytes = CF::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CF::P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fft_kernel<LOG_M, MODE>, a);
}

// N a power of two in [8, 65536]; rows = B * a.J.
template <int MODE>
int dispatch(int N, int rows, const Args& a, void* stream) {
  int log_m = 0;
  while ((2 << log_m) < N) ++log_m;
  if ((2 << log_m) != N || log_m < 2 || log_m > 15 || rows < 0 || rows > 65535)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (log_m) {
#define FFT_CASE(L) \
  case L: return (int)launch_one<L, MODE>(a, rows, st);
    FFT_CASE(2) FFT_CASE(3) FFT_CASE(4) FFT_CASE(5) FFT_CASE(6) FFT_CASE(7)
    FFT_CASE(8) FFT_CASE(9) FFT_CASE(10) FFT_CASE(11) FFT_CASE(12) FFT_CASE(13)
    FFT_CASE(14) FFT_CASE(15)
#undef FFT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// All tensors contiguous on the current device.  Each returns the CUDA
// error of its launch (0 on success).

// x (B, N) f64 -> out (B, 2, N/2) f64.
int fft_forward_launch(const void* x, void* out, int B, int N, void* stream) {
  return dispatch<kFwdFloat>(N, B, Args{x, nullptr, out, 1, 1, 0}, stream);
}

// spec (B, 2, N/2) f64 -> x (B, N) f64.
int fft_inverse_launch(const void* spec, void* x, int B, int N, void* stream) {
  return dispatch<kInvFloat>(N, B, Args{spec, nullptr, x, 1, 1, 0}, stream);
}

// src (B, K, N) int64, shifts (B,) int64 or null -> out (B, 2, K*level, N/2)
// f64; 0 < base_log <= 32, base_log * level <= 64.
int fft_forward_digits_launch(const void* src, const void* shifts, void* out, int B,
                              int K, int N, int base_log, int level, void* stream) {
  if (base_log < 1 || base_log > 32 || level < 1 || base_log * level > 64 || K < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch<kFwdDigits>(
      N, B * K * level,
      Args{src, static_cast<const int64_t*>(shifts), out, K * level, level, base_log},
      stream);
}

// planes (B, 2, K, N/2) f64, acc (B, K, N) int64 or null -> out (B, K, N) int64.
int fft_inverse_torus_launch(const void* planes, const void* acc, void* out, int B,
                             int K, int N, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  return dispatch<kInvTorus>(
      N, B * K, Args{planes, static_cast<const int64_t*>(acc), out, K, 1, 0}, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
