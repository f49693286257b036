// The CPMM's digit arithmetic around the int8 GEMM, for Hopper (sm_90a): the
// balanced-digit split of a limb of x and the fold of a digit bucket's
// product back to canonical residues.
//
// No Pallas kernel computes any of this: in the JAX package it is the jnp
// code of moai_tpu/modmat.py (the digit split and the per-bucket remainder,
// Montgomery multiply and add around jnp's int8 dot), which XLA fuses.  The
// port's mod_matmul (moai_tpu_torch/modmat.py) runs, per limb l of x
// [J, P, L, N] and weights W [J, I]:
//   digit_split  x[:, :, l, :] -> xd [P * N, 4 * Jp] int8, row p * N + n
//                holding the 4 balanced digit planes of column n, each Jp
//                wide (j < J the digits of x[j, p, l, n], the rest zero);
//   torch._int_mm, one per digit bucket k (0..6): the sum over dx of digit
//                plane dx of x against digit plane k - dx of W, as one GEMM
//                over a column window of xd and of W's digit matrix
//                (cuBLASLt; no kernel of this file);
//   bucket_fold  acc = (acc + part_k * 2^(8k) mod q) mod q from the
//                bucket's int32 product, into a scratch accumulator and, for
//                the last bucket, into out[:, :, l, :].
//
// Residues are int32 lanes holding the JAX package's uint32 Montgomery
// values.  Both kernels equal their plain versions (modmat.py's
// digit_split_plain and bucket_fold_plain) bit for bit: the digits are the
// same integers, and the fold writes the canonical residue.
//
// Bound: memory.  digit_split reads each int32 of the limb once and writes
// four int8 digits (8 bytes an element); bucket_fold reads the bucket's
// product and the accumulator and writes the accumulator (12 bytes an
// element), with one 32x32 -> 64 product and a REDC per element, far below
// the card's integer rate.  What the design does about it:
// - digit_split moves a 64 x 64 tile of (j, n) through shared memory: a warp
//   reads 32 consecutive coefficients of one row of x (128 bytes), and a
//   thread then writes 16 consecutive digits of one plane as one 16-byte
//   store, four threads a 64-byte run of j, so the transpose costs no
//   uncoalesced access on either side.  Each row of x is read through its
//   strides (a limb of a larger tensor, or a window of its limbs).
// - bucket_fold folds the signed product with one Montgomery multiply: a
//   multiple of q in [2^29, 2^29 + q) makes it non-negative below 2^30 + q,
//   and REDC((part + bias) * 2^(8k) R) lands below 1.5 q for the port's
//   primes (odd, below 2^30, as mod_arith.mont_constants requires), so one
//   subtract makes it canonical, with no division on any element.  A thread moves four residues per 16-byte load and store (the
//   wrapper takes only N a multiple of 4 and rows on 16-byte boundaries,
//   as every limb of the port is).
// - Loads are coalesced, consecutive threads on consecutive coefficients.

#include <cuda_runtime.h>
#include <stdint.h>

// The launches' arguments, passed by value (the Python side fills ctypes
// mirrors of these structs; moai_modmat_sizes lets it check their sizes).
typedef long long i64;

constexpr int kDigits = 4;       // balanced int8 digits of a residue

struct DigitSplitArgs {
  const int* x;                  // x[j * sj + p * sp + n]: one limb
  i64 sj, sp;
  signed char* out;              // [P * N, kDigits * Jp], row-major
  int J, Jp, P, N;
};

struct BucketFoldArgs {
  const int* part;               // [>= I, P * N], contiguous
  const int* acc;                // [I, P, N], contiguous, or null (zero)
  int* out;                      // out[i * oi + p * op + n]
  i64 oi, op;
  const int* q;                  // the limb's prime
  const int* c;                  // 2^(8k) * R mod q
  int I, P, N;
};

namespace {

typedef unsigned long long u64;

// -q^-1 mod 2^32 for odd q (four Newton steps, as csrc/limb.cu).
__device__ __forceinline__ uint32_t neg_qinv(uint32_t q) {
  uint32_t x = q;
  x *= 2u - q * x;
  x *= 2u - q * x;
  x *= 2u - q * x;
  x *= 2u - q * x;
  return 0u - x;
}

// REDC: T * 2^-32 mod q, below T / 2^32 + q, for T < 2^63, odd q < 2^31.
__device__ __forceinline__ uint32_t redc(u64 T, uint32_t q, uint32_t qn) {
  const uint32_t m = (uint32_t)T * qn;
  return (uint32_t)((T + (u64)m * q) >> 32);
}

// ---------------------------------------------------------------------------
// digit_split
// ---------------------------------------------------------------------------

constexpr int kSplitTile = 64;                     // j and n of a block's tile
constexpr int kSplitThreads = 256;
constexpr int kSplitRun = 16;                      // digits a thread stores

__global__ void __launch_bounds__(kSplitThreads) digit_split(const __grid_constant__ DigitSplitArgs a) {
  __shared__ int tile[kSplitTile][kSplitTile + 1];
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * kSplitTile, j0 = blockIdx.y * kSplitTile;
  const int p = blockIdx.z;
  const int* x = a.x + p * a.sp;
  {
    // a warp reads 32 consecutive coefficients of one row j
    const int nl = t % kSplitTile, n = n0 + nl;
    constexpr int kRows = kSplitThreads / kSplitTile;
#pragma unroll
    for (int r = 0; r < kSplitTile / kRows; ++r) {
      const int jl = t / kSplitTile + kRows * r, j = j0 + jl;
      tile[jl][nl] = (j < a.J && n < a.N) ? __ldg(x + j * a.sj + n) : 0;
    }
  }
  __syncthreads();
  // a thread takes kSplitRun consecutive j of one coefficient n
  constexpr int kGroups = kSplitTile / kSplitRun;
  const int nl = t / kGroups, g = t % kGroups;
  const int n = n0 + nl, jb = j0 + g * kSplitRun;
  if (n >= a.N || jb >= a.Jp) return;
  uint32_t w[kDigits][kSplitRun / 4];
#pragma unroll
  for (int d = 0; d < kDigits; ++d)
#pragma unroll
    for (int v = 0; v < kSplitRun / 4; ++v) w[d][v] = 0;
#pragma unroll
  for (int i = 0; i < kSplitRun; ++i) {
    // balanced digits: d = cur & 0xFF, minus 256 above 127, carried
    int cur = tile[g * kSplitRun + i][nl];
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      int v = cur & 0xFF;
      const int carry = v > 127;
      v -= carry << 8;
      cur = (cur >> 8) + carry;
      w[d][i / 4] |= (uint32_t)(v & 0xFF) << (8 * (i % 4));
    }
  }
  signed char* row = a.out + ((i64)p * a.N + n) * (i64)(kDigits * a.Jp) + jb;
#pragma unroll
  for (int d = 0; d < kDigits; ++d)
    *(uint4*)(row + (i64)d * a.Jp) = make_uint4(w[d][0], w[d][1], w[d][2], w[d][3]);
}

// ---------------------------------------------------------------------------
// bucket_fold
// ---------------------------------------------------------------------------

constexpr int kFoldThreads = 256;
constexpr int kFoldLanes = 4;                      // residues a thread moves

__global__ void __launch_bounds__(kFoldThreads) bucket_fold(const __grid_constant__ BucketFoldArgs a) {
  const int n = (blockIdx.x * kFoldThreads + threadIdx.x) * kFoldLanes;
  if (n >= a.N) return;
  const uint32_t q = (uint32_t)*a.q, qn = neg_qinv(q), c = (uint32_t)*a.c;
  // a multiple of q in [2^29, 2^29 + q): |part| <= 2^29, so part + bias
  // lies in [0, 2^30 + q), added in uint32, and for q < 2^30 REDC of its
  // product with c < q stays below (2^30 + q) q / 2^32 + q < 1.5 q
  const uint32_t bias = ((1u << 29) + q - 1) / q * q;
  const i64 rows = (i64)a.I * a.P;
  for (i64 r = blockIdx.y; r < rows; r += gridDim.y) {
    const i64 i = r / a.P, p = r % a.P;
    const i64 src = r * a.N + n;         // part row i, column p * N + n
    const uint4 pv = *(const uint4*)(a.part + src);
    const uint4 av = a.acc ? *(const uint4*)(a.acc + src) : make_uint4(0, 0, 0, 0);
    const uint32_t pk[kFoldLanes] = {pv.x, pv.y, pv.z, pv.w};
    const uint32_t ak[kFoldLanes] = {av.x, av.y, av.z, av.w};
    uint32_t res[kFoldLanes];
#pragma unroll
    for (int k = 0; k < kFoldLanes; ++k) {
      uint32_t f = redc((u64)(pk[k] + bias) * c, q, qn);
      f = f >= q ? f - q : f;
      const uint32_t s = ak[k] + f;
      res[k] = s >= q ? s - q : s;
    }
    *(uint4*)(a.out + i * a.oi + p * a.op + n) = make_uint4(res[0], res[1], res[2], res[3]);
  }
}

unsigned grid_rows(i64 rows) { return (unsigned)(rows < 65535 ? rows : 65535); }

}  // namespace

extern "C" {

int moai_digit_split(const DigitSplitArgs* a, void* stream) {
  const dim3 grid((unsigned)((a->N + kSplitTile - 1) / kSplitTile),
                  (unsigned)((a->Jp + kSplitTile - 1) / kSplitTile), (unsigned)a->P);
  digit_split<<<grid, kSplitThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// N is a multiple of kFoldLanes and every row starts on a 16-byte boundary
// (the wrapper checks).
int moai_bucket_fold(const BucketFoldArgs* a, void* stream) {
  const dim3 grid((unsigned)((a->N / kFoldLanes + kFoldThreads - 1) / kFoldThreads),
                  grid_rows((i64)a->I * a->P));
  bucket_fold<<<grid, kFoldThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// The sizes of the argument structs, which the Python side checks against
// its ctypes mirrors before the first launch.
int moai_modmat_sizes(int* out) {
  out[0] = (int)sizeof(DigitSplitArgs);
  out[1] = (int)sizeof(BucketFoldArgs);
  return 0;
}

}  // extern "C"
