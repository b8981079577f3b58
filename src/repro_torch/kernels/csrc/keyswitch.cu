// Key-switch MAC for Hopper (sm_90a) on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/keyswitch.py::keyswitch_mac
// (body `_kernel`, 16-bit sub-limb product `_mul64`).  It computes
//
//     acc[b, t] = sum_s d[b, s] * K[s, t]   (mod 2^64)
//
// with d the signed gadget digits (S = big_n * ks_level) and K the int64
// key-switching key; the caller forms (0, b) - acc.
//
// The identity.  Each KSK word is eight little-endian bytes,
// K[s, t] = sum_l 2^(8l) u_l[s, t] with u_l in [0, 255], so
//
//     acc[b, t] = sum_l 2^(8l) P_l[b, t]   (mod 2^64),
//     P_l[b, t] = sum_s d[b, s] u_l[s, t].
//
// Every digit fits int8 (ks_base_log <= 8), and over a stretch of at most
// 65,536 rows of S each P_l is an exact int32 (65,536 x 128 x 255 < 2^31):
// one s8 x u8 -> s32 tensor-core product.  This is the tensor-core form of
// the TPU kernel's 16-bit sub-limbs.  Viewed as bytes, the (S, T) int64 key
// is an (S, 8T) u8 matrix whose column 8t + l holds limb l of column t; the
// caller stores it once per key K-major as the (8T, S16) "limb operand"
// (S16 = S rounded up to 16, zero columns).  So the keyswitch is one int8
// GEMM, M = 8T limb rows, N = B digit rows, K = S, whose epilogue folds the
// 8 limb rows of each t into one wrapping uint64.
//
// Bound on the card: at the paper's gpt2 parameters the limb operand is
// 1.58 GB, read once (0.47 ms at 3.35 TB/s), against 2 B S 8T int8
// operations (0.46 ms at 1,979 TOP/s for B = 288 rows, 0.02 ms at B = 12).
// A 64-bit multiply-add on CUDA cores costs about three 32-bit IMADs, which
// put the CUDA-core design at ~11 ms for 288 rows; the tensor cores remove
// that floor.  The design:
//  * one block per (128 limb rows, S stretch, row group of up to 288
//    digit rows); all rows of a round share each limb tile, so each KSK
//    byte is read from device memory once per round;
//  * one producer thread keeps TMA loads of the limb tile and the digit
//    tile (128 bytes of S each, 128-byte swizzle, zero fill at the ragged
//    S, T and row edges) in flight over a ring of shared-memory stages;
//    two consumer warpgroups each run wgmma m64nNk32 (limbs as A, digits
//    as B, both K-major as 8-bit wgmma requires) into s32 registers;
//  * S is split into stretches (<= 65,536 rows, for exactness) so the grid
//    fills the card; blocks of one stretch are adjacent in launch order,
//    so the stretch's digit slice is read from device memory once and
//    then served from L2 (TMA hint: evict_last; the limbs stream with
//    evict_first);
//  * epilogue: in the accumulator fragment a thread holds rows
//    (limb rows) 16w + lane/4 and +8, so the 8 limbs of one t sit in the
//    8 lanes of equal lane % 4.  Each lane sign-extends and shifts its
//    limb product by 8 * (lane / 4) in uint64, three xor-shuffles sum the
//    8, and one wrapping atomicAdd per (row, t, block) lands in the zeroed
//    output.  Wrapping addition ignores order, so the result is bit-exact
//    whatever the schedule.
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 128;          // bytes of S per stage: one swizzle row
constexpr int kBM = 128;          // limb rows per block: 2 warpgroups x 64
constexpr int kMaxStretch = 65536 / kBK;   // stages of S per block, max
constexpr int kThreads = 384;     // warpgroups 0-1 consume, 2 produces
constexpr int kSmemBudget = 215 * 1024;
constexpr int kMaxStages = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// 2-D TMA load of one box at (c0 = byte of S, c1 = row) into shared memory,
// completing `bytes` on `bar`, with an L2 eviction-priority hint.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart (SBO).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// Pin an accumulator register across the asynchronous wgmma window.
__device__ __forceinline__ void fence_reg(int32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// wgmma.m64nNk32.s32.u8.s8: limbs (A, u8) x digits (B, s8), both from
// shared memory, accumulate into d (N/2 s32 registers per thread).
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(int32_t (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int32_t (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int32_t (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
      "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
      "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<144> {
  __device__ __forceinline__ static void mma(int32_t (&d)[72], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
      "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
      "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
      "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
      "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
      "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <int NB, int NC, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
keyswitch_mac_kernel(const __grid_constant__ CUtensorMap limb_map,
                     const __grid_constant__ CUtensorMap digit_map,
                     unsigned long long* __restrict__ out,
                     int R, int T, int n_k, int k_per_block) {
  constexpr int kRows = NB * NC;                 // digit rows per block
  constexpr int kLimbBytes = kBM * kBK;
  constexpr int kStageBytes = kLimbBytes + kRows * kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1 KB aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem_raw + (base - raw) + STAGES * kStageBytes);
  uint64_t* empty = full + STAGES;

  const int k_begin = blockIdx.y * k_per_block;
  const int k_count = min(n_k, k_begin + k_per_block) - k_begin;
  if (k_count <= 0) return;                      // uniform for the block
  const int m0 = blockIdx.x * kBM;               // first limb row
  const int r0 = blockIdx.z * kRows;             // first digit row

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- producer warpgroup: one thread issues every TMA load -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      uint64_t stream, keep;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(stream));
      asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
      for (int i = 0; i < k_count; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStageBytes);
        const int k = (k_begin + i) * kBK;
        const uint32_t dst = base + s * kStageBytes;
        tma_load(dst, &limb_map, k, m0, &full[s], stream);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(dst + kLimbBytes + c * NB * kBK, &digit_map, k, r0 + c * NB,
                   &full[s], keep);
      }
    }
  } else {
    // -- consumer warpgroups: limb rows 64 wg .. 64 wg + 63 --------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    int32_t acc[NC][NB / 2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[c][i] = 0;

    for (int i = 0; i < k_count; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const uint32_t a = base + s * kStageBytes + wg * 64 * kBK;
      const uint32_t b = base + s * kStageBytes + kLimbBytes;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) fence_reg(acc[c][j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          Wgmma<NB>::mma(acc[c], smem_desc(a + kk * 32),
                         smem_desc(b + c * NB * kBK + kk * 32));
      wgmma_commit();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) fence_reg(acc[c][j]);
      wgmma_wait<1>();                 // the previous stage's products are done
      if (i > 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < NB / 2; ++j) fence_reg(acc[c][j]);

    // -- epilogue: fold the 8 limb rows of each t into one uint64 ---------
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int limb = lane >> 2;
    const int t0 = (m0 + wg * 64 + warp * 16) / 8;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < NB / 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = t0 + (q >> 1);
          const int row = r0 + c * NB + 8 * i + 2 * (lane & 3) + (q & 1);
          unsigned long long v = static_cast<unsigned long long>(
              static_cast<long long>(acc[c][4 * i + q])) << (8 * limb);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (limb == 0 && row < R && t < T)
            atomicAdd(out + static_cast<size_t>(row) * T + t, v);
        }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime so
// the library links against nothing but the CUDA runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
        ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major (rows, cols) byte matrix, boxes of 128 bytes
// by `box_rows`, 128-byte swizzle, zero fill outside the matrix.
bool byte_matrix_map(CUtensorMap* map, const void* ptr, int cols, int rows,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Stretches of S per column of blocks: the fewest that keep each stretch
// within kMaxStretch stages and, among those up to 8 more, the one with
// the least (waves x stages per block) on this card.
int choose_splits(int n_k, int blocks_per_split, int sms) {
  const int lo = (n_k + kMaxStretch - 1) / kMaxStretch;
  int best = lo;
  long long best_cost = -1;
  for (int sp = lo; sp <= lo + 8 && sp <= n_k; ++sp) {
    const long long waves = (static_cast<long long>(blocks_per_split) * sp + sms - 1) / sms;
    const long long cost = waves * ((n_k + sp - 1) / sp);
    if (best_cost < 0 || cost < best_cost) {
      best = sp;
      best_cost = cost;
    }
  }
  return best;
}

template <int NB, int NC>
int launch(const void* digits, const void* limbs, unsigned long long* out,
           int R, int S16, int T, cudaStream_t st) {
  constexpr int kRows = NB * NC;
  constexpr int kStageBytes = kBM * kBK + kRows * kBK;
  constexpr int kStages = kSmemBudget / kStageBytes < kMaxStages
      ? kSmemBudget / kStageBytes : kMaxStages;
  constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
  CUtensorMap limb_map, digit_map;
  if (!byte_matrix_map(&limb_map, limbs, S16, 8 * T, kBM)
      || !byte_matrix_map(&digit_map, digits, S16, R, NB))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = keyswitch_mac_kernel<NB, NC, kStages>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (8 * T + kBM - 1) / kBM;
  const int groups = (R + kRows - 1) / kRows;
  const int n_k = (S16 + kBK - 1) / kBK;
  const int sp = choose_splits(n_k, tiles * groups, sms);
  const int k_per_block = (n_k + sp - 1) / sp;
  const dim3 grid(tiles, sp, groups);
  kernel<<<grid, kThreads, kSmem, st>>>(limb_map, digit_map, out, R, T, n_k,
                                        k_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// digits (R, S16) int8 and limbs (8T, S16) uint8, row-major, S16 a
// multiple of 16 and both 16-byte aligned; out (R, T) int64 ZEROED by the
// caller; all on the current device.  Rows per block: the smallest of
// 16 / 32 / 64 / 144 / 288 that holds R (row groups of 288 beyond).
int keyswitch_mac_launch(const void* digits, const void* limbs, void* out,
                         int R, int S16, int T, void* stream) {
  auto o = static_cast<unsigned long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || T <= 0 || S16 <= 0 || S16 % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 16) return launch<16, 1>(digits, limbs, o, R, S16, T, st);
  if (R <= 32) return launch<32, 1>(digits, limbs, o, R, S16, T, st);
  if (R <= 64) return launch<64, 1>(digits, limbs, o, R, S16, T, st);
  if (R <= 144) return launch<144, 1>(digits, limbs, o, R, S16, T, st);
  return launch<144, 2>(digits, limbs, o, R, S16, T, st);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
