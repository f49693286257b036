// The RNS limb arithmetic of the CKKS scheme, for Hopper (sm_90a): the
// Montgomery elementwise family, fast base conversion, the key-switch MAC
// and the bootstrap's plaintext-diagonal MAC.
//
// No Pallas kernel computes any of this: in the JAX package it is jnp code
// that XLA fuses into one pass over the residues.  Each entry point replaces
//   moai_limb_ew   <- moai_tpu/mod_arith.py:96 mont_mul, :124 to_mont,
//                     :129 from_mont, :151-161 add_mod/sub_mod/neg_mod, and
//                     the sub-then-multiply tails of rescale
//                     (moai_tpu/evaluator.py:191) and _mod_down_p (:340);
//   moai_base_conv <- the base extensions of _ks_decompose
//                     (moai_tpu/evaluator.py:248), _mod_down_p (:340) and
//                     ModRaise (moai_tpu/boot/bootstrap.py:124);
//   moai_ks_mac    <- the digit MAC of _ks_mac_moddown
//                     (moai_tpu/evaluator.py:307), with the gather of
//                     rotate_hoisted (:456) folded in;
//   moai_diag_mac  <- the giant step's sum of multiply_plain + add_mod in
//                     apply_diagonals (moai_tpu/boot/linear.py:59).
//
// Residues are int64 lanes holding the JAX package's uint32 Montgomery
// values (x * 2^32 mod q, q an odd prime below 2^30).  Every kernel writes
// the canonical residue in [0, q), so it equals the torch ops it replaces
// (moai_tpu_torch/mod_arith.py, the *_plain functions) bit for bit.
//
// Bound: memory.  Each int64 input is read once and each output written
// once at 3.35 TB/s; the arithmetic is a few 32- and 64-bit integer
// multiplies per element, below the card's integer rate (base_conv, with
// up to 13 products per output, comes closest).  What the design does
// about it:
// - Reduction is Montgomery's REDC with R = 2^32 (one 32x32 low multiply,
//   one 32x32 -> 64 multiply-add, a shift), with no division on any
//   residue in range; -q^-1 mod 2^32 comes from four Newton steps on q, so
//   no table of it is read.  The elementwise ops take any int64 input, as
//   the torch ops do: operands past the residues' range (never on the
//   scheme's paths) take a branch with the int64 remainder.
// - ks_mac and diag_mac add up to four products of residues in 64 bits
//   (each below 2^30 * q, four below q * 2^32, REDC's input range) before
//   one REDC, and keep a canonical 32-bit sum across groups.
// - base_conv is a modular GEMM per (b, d) with register tiles of 4
//   targets x 2 coefficients: one shared load of hat feeds eight
//   multiply-adds, the sums stay lazy over up to 16 products in 64 bits,
//   and two REDC steps against hat * 2^32 reduce each sum once.
// - ks_mac reads each key element once per launch (a thread holds its
//   coefficient's key values and walks the rows of y), reads the key where
//   it lies (no copy of the active limbs), and gathers y through a
//   rotation's permutation instead of materialising the rotated digits.
// - diag_mac keeps a coefficient's diagonals in registers and walks the
//   ciphertexts' rows, so each diagonal and each rotated ciphertext is read
//   once per giant step.
// - Loads are coalesced, consecutive threads on consecutive coefficients;
//   each elementwise thread keeps four loads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

// The launches' arguments, passed by value (the Python side fills ctypes
// mirrors of these structs; moai_limb_sizes lets it check their sizes).
// They sit outside the anonymous namespace so that the C entry points that
// take them keep external linkage.
typedef long long i64;

constexpr int kMaxDims = 6;
constexpr int kOperands = 4;   // a, b, c, q
constexpr int kMaxIn = 32;     // input limbs of one base_conv digit
constexpr int kMaxDigits = 16; // digits of one ks_mac launch
constexpr int kMaxRot = 64;    // rotations of one ks_mac launch
constexpr int kMaxTerms = 32;  // diagonals of one diag_mac launch

struct Operand {
  const void* ptr;             // null: every element is `value`
  i64 value;
  i64 stride[kMaxDims];        // in elements, 0 along broadcast dims
  int is32;                    // int32 elements, else int64
};

struct EwArgs {
  Operand in[kOperands];
  i64* out;                    // contiguous, the broadcast shape
  i64 size[kMaxDims];          // the collapsed shape, innermost last
  i64 rows;                    // product of all but the innermost size
  int ndim;
  int op;
};

struct BaseConvArgs {
  const i64* x;                   // [B, S, N]
  const i64* src_q;               // [S]
  const i64* hatinv;              // [S] or null
  const i64* hat;                 // hat[d * hs0 + a * hs1 + t * hs2]
  i64 hs0, hs1, hs2;
  const i64* tq;                  // tq[t * tqs]
  i64 tqs;
  const i64* k;                   // [B, N] or null
  const i64* kq;                  // kq[t * kqs]
  i64 kqs;
  i64* out;                       // [B, D, T, N]
  i64 B;
  int S, N, D, A, T;
};

struct KsMacArgs {
  const i64* y;                   // [B, D, T, N]
  const i64* perm;                // [R, N] or null (R == 1)
  const void* key[kMaxRot];       // each [>= D, 2, KL, N]
  const i64* tq;                  // tq[t * tqs]
  i64 tqs;
  i64* out;                       // [2, R, B, T, N]
  i64 B;
  int key32, KL, split, kgap;
  int R, D, T, N;
};

struct DiagMacArgs {
  const i64* ct[kMaxTerms];       // each [B, L, N]
  const i64* pt;                  // [terms, L, N]
  const i64* q;                   // q[l * qs]
  i64 qs;
  i64* out;                       // [B, L, N]
  i64 B;
  int terms, L, N;
};

namespace {

typedef unsigned long long u64;

// -q^-1 mod 2^32 for odd q: q * q = 1 mod 8, and each Newton step doubles
// the bits that are right (3, 6, 12, 24, 48).
__device__ __forceinline__ uint32_t neg_qinv(uint32_t q) {
  uint32_t x = q;
  x *= 2u - q * x;
  x *= 2u - q * x;
  x *= 2u - q * x;
  x *= 2u - q * x;
  return 0u - x;
}

// REDC: t = T * 2^-32 mod q up to a few q, t < T / 2^32 + q, for
// T < 2^63 and odd q < 2^31 (then T + m q < 2^64).
__device__ __forceinline__ u64 redc(u64 T, uint32_t q, uint32_t qn) {
  const uint32_t m = (uint32_t)T * qn;
  return (T + (u64)m * q) >> 32;
}

// x mod q as torch's remainder computes it (floored: the sign of q).
__device__ __forceinline__ i64 floor_mod(i64 x, i64 q) {
  const i64 r = x % q;
  return r < 0 ? r + q : r;
}

// s mod q, floored, for any int64 s; s in [-q, 2q) takes no division.
__device__ __forceinline__ i64 reduce(i64 s, i64 q) {
  if (s >= q) s -= q;
  else if (s < 0) s += q;
  return (u64)s < (u64)q ? s : floor_mod(s, q);
}

// a * b * 2^-32 mod q, canonical, equal to mod_arith.mont_mul_plain for
// any int64 a, b (its int64 product wraps as torch's does).
__device__ __forceinline__ i64 mont_mul(i64 a, i64 b, uint32_t q, uint32_t qn) {
  const u64 ua = (u64)a, ub = (u64)b;
  if ((ua | ub) < (1ull << 32)) {
    const u64 T = ua * ub;
    if (T < (1ull << 63)) {
      u64 t = redc(T, q, qn);            // < 2^31 + q
      if (t >= q) t -= q;
      return t < q ? (i64)t : (i64)(t % q);
    }
  }
  const u64 t = redc((u64)floor_mod((i64)(ua * ub), q), q, qn);   // < q
  return (i64)(t >= q ? t - q : t);
}

// x * 2^-32 mod q, canonical, equal to mod_arith.from_mont_plain
// ((x * rinv) % q in int64) for any int64 x.
__device__ __forceinline__ i64 from_mont(i64 x, uint32_t q, uint32_t qn) {
  if ((u64)x < (1ull << 32)) {           // x * rinv < 2^63: exact in int64
    const u64 t = redc((u64)x, q, qn);   // < q + 1
    return (i64)(t >= q ? t - q : t);
  }
  const u64 rinv = ((u64)q * qn + 1) >> 32;   // 2^-32 mod q, canonical
  return floor_mod((i64)((u64)x * rinv), q);
}

// A canonical sum of canonical residues: acc + t mod q, both below q.
__device__ __forceinline__ uint32_t add_canon(uint32_t acc, uint32_t t, uint32_t q) {
  const uint32_t s = acc + t;
  return s >= q ? s - q : s;
}

// REDC of a group sum below q * 2^32, made canonical.
__device__ __forceinline__ uint32_t redc_canon(u64 T, uint32_t q, uint32_t qn) {
  const uint32_t t = (uint32_t)redc(T, q, qn);
  return t >= q ? t - q : t;
}

// ---------------------------------------------------------------------------
// limb_ew: out = op(a, b, c) mod q over the broadcast of its operands
// ---------------------------------------------------------------------------

enum EwOp { kAdd = 0, kSub = 1, kNeg = 2, kMul = 3, kFromMont = 4, kSubMul = 5 };

constexpr int kEwThreads = 256;
constexpr int kEwVec = 4;      // elements (loads in flight) per thread



__device__ __forceinline__ i64 load(const Operand& o, i64 off) {
  if (!o.ptr) return o.value;
  return o.is32 ? (i64)((const int*)o.ptr)[off] : ((const i64*)o.ptr)[off];
}

__global__ void __launch_bounds__(kEwThreads) limb_ew(const __grid_constant__ EwArgs a) {
  const int nd = a.ndim;
  const i64 inner = a.size[nd - 1];
  const i64 j0 = (i64)blockIdx.x * (kEwThreads * kEwVec) + threadIdx.x;
  for (i64 row = blockIdx.y; row < a.rows; row += gridDim.y) {
    i64 base[kOperands] = {0, 0, 0, 0};
    uint32_t r = (uint32_t)row;           // rows < 2^31 (the wrapper checks)
    for (int d = nd - 2; d >= 0; --d) {
      const uint32_t sz = (uint32_t)a.size[d];
      const i64 i = r % sz;
      r /= sz;
#pragma unroll
      for (int k = 0; k < kOperands; ++k) base[k] += i * a.in[k].stride[d];
    }
    i64 v[kOperands][kEwVec];
#pragma unroll
    for (int e = 0; e < kEwVec; ++e) {
      const i64 j = j0 + e * kEwThreads;
      if (j < inner) {
#pragma unroll
        for (int k = 0; k < kOperands; ++k)
          v[k][e] = load(a.in[k], base[k] + j * a.in[k].stride[nd - 1]);
      }
    }
#pragma unroll
    for (int e = 0; e < kEwVec; ++e) {
      const i64 j = j0 + e * kEwThreads;
      if (j >= inner) continue;
      const i64 x = v[0][e], y = v[1][e], q = v[3][e];
      i64 res;
      switch (a.op) {
        case kAdd: res = reduce((i64)((u64)x + (u64)y), q); break;
        case kSub: res = reduce((i64)((u64)x - (u64)y), q); break;
        case kNeg: res = reduce((i64)(0ull - (u64)x), q); break;
        case kMul: res = mont_mul(x, y, (uint32_t)q, neg_qinv((uint32_t)q)); break;
        case kFromMont: res = from_mont(x, (uint32_t)q, neg_qinv((uint32_t)q)); break;
        default:                         // kSubMul: (x - y mod q) * c
          res = mont_mul(reduce((i64)((u64)x - (u64)y), q), v[2][e], (uint32_t)q,
                         neg_qinv((uint32_t)q));
      }
      a.out[row * inner + j] = res;
    }
  }
}

// ---------------------------------------------------------------------------
// base_conv: out[b, d, t] = sum_a lam[b, d*A + a] * hat[d, a, t] * 2^-32
//            (- k[b] * kq[t] * 2^-32)  mod tq[t]
// lam = from_mont(mont_mul(x, hatinv)) mod src_q, or x itself (no hatinv).
//
// For each (b, d) this is a modular GEMM, out[T, n] = hat[d]^T [T, cnt] .
// lam [cnt, n].  A block takes one (b, d) row and kConvCoeffs coefficients;
// each thread owns two neighbouring coefficients, converts their cnt inputs
// once into registers, and walks the targets in register tiles of
// kConvTile targets x 2 coefficients: one 16-byte shared load of hat feeds
// eight independent 64-bit multiply-adds.  The sums are lazy: up to kLazy
// products below 2^60 each stay below 2^64, and each group is reduced
// once by two REDC steps (S * 2^-64, in [0, q]) against hat * 2^32 mod q,
// which the block computes once per digit into shared memory.  An input
// becomes lam by one REDC against hatinv * 2^-32, also computed once per
// block.  Outputs go out as one 16-byte store per target and thread.
// ---------------------------------------------------------------------------

constexpr int kConvThreads = 128;
constexpr int kConvCoeffs = 2 * kConvThreads;   // coefficients of one block
constexpr int kConvTile = 4;                    // targets of a register tile
constexpr int kLazy = 16;                       // products of one 64-bit sum

// S * 2^-64 mod q, canonical, for any S < 2^64 and odd q < 2^31: two REDC
// steps, the first on the full 64-bit S (S1 = S >> 32 + (lo + m q) >> 32
// <= 2^32 - 1 + q), the second on S1 (S1 + m q < 2^32 (q + 1), so the
// result is at most q).
__device__ __forceinline__ uint32_t redc2_canon(u64 S, uint32_t q, uint32_t qn) {
  const uint32_t m1 = (uint32_t)S * qn;
  const u64 s1 = (S >> 32) + (((u64)m1 * q + (uint32_t)S) >> 32);
  const uint32_t m2 = (uint32_t)s1 * qn;
  const uint32_t s2 = (uint32_t)((s1 + (u64)m2 * q) >> 32);
  return s2 >= q ? s2 - q : s2;
}

// lam = from_mont(mont_mul(v, hatinv)) mod q, as the torch ops compute it.
// Where their int64 product is exact (v < 2^32, hatinv < 2^31: c.w) this
// is one REDC of v * (hatinv * 2^-32 mod q) (c.z), below 2q; other
// operands take the elementwise ops' general path.
__device__ __forceinline__ uint32_t to_lam(i64 v, uint4 c, const i64* hatinv) {
  if (c.w && (u64)v < (1ull << 32)) return redc_canon((u64)v * c.z, c.x, c.y);
  return (uint32_t)from_mont(mont_mul(v, *hatinv, c.x, c.y), c.x, c.y);
}

// Up to MAXC inputs a digit (a compile-time bound, so lam stays in
// registers); cnt <= MAXC at run time.  Six blocks an SM (80 registers
// for MAXC 16) ran faster on the H100 than four at 90 registers.
template <int MAXC>
__global__ void __launch_bounds__(kConvThreads, 6) base_conv(const __grid_constant__ BaseConvArgs a) {
  extern __shared__ uint32_t sm[];
  const int Tp = (a.T + kConvTile - 1) / kConvTile * kConvTile;
  uint32_t* s_q = sm;                 // [Tp], 1 past T
  uint32_t* s_qn = s_q + Tp;
  uint32_t* s_r2 = s_qn + Tp;         // 2^64 mod q
  uint32_t* s_kq = s_r2 + Tp;
  uint32_t* s_hat = s_kq + Tp;        // [cnt][Tp]: hat * 2^32 mod q, 0 past T
  uint4* s_src = (uint4*)(s_hat + a.A * Tp);   // [cnt]: q, -q^-1, hatinv
                                               // * 2^-32, lean path ok
  for (int t = threadIdx.x; t < Tp; t += kConvThreads) {
    const uint32_t q = t < a.T ? (uint32_t)a.tq[t * a.tqs] : 1u;
    const uint32_t r1 = (0u - q) % q;                 // 2^32 mod q
    s_q[t] = q;
    s_qn[t] = neg_qinv(q);
    s_r2[t] = (uint32_t)((u64)r1 * r1 % q);
    s_kq[t] = a.k && t < a.T ? (uint32_t)a.kq[t * a.kqs] : 0u;
  }
  const int n = (blockIdx.x * kConvThreads + threadIdx.x) * 2;   // N is even
  for (i64 bd = blockIdx.y; bd < a.B * a.D; bd += gridDim.y) {
    const int d = (int)(bd % a.D);
    const i64 b = bd / a.D;
    const int lo = d * a.A;
    const int cnt = min(a.A, a.S - lo);
    __syncthreads();                  // the tables are written, the previous
                                      // row's readers of s_hat are done
#pragma unroll 4
    for (int i = threadIdx.x; i < cnt * Tp; i += kConvThreads) {
      const int ai = i / Tp, t = i - ai * Tp;
      uint32_t h = 0;
      if (t < a.T) {                  // hat < 2^32, r2 < q: below 2q
        const uint32_t q = s_q[t];
        h = redc_canon((u64)(uint32_t)a.hat[d * a.hs0 + ai * a.hs1 + t * a.hs2] * s_r2[t],
                       q, s_qn[t]);
      }
      s_hat[i] = h;
    }
    if (a.hatinv) {
      for (int i = threadIdx.x; i < cnt; i += kConvThreads) {
        const uint32_t q = (uint32_t)a.src_q[lo + i], qn = neg_qinv(q);
        const i64 hi = a.hatinv[lo + i];
        s_src[i] = make_uint4(q, qn, (uint32_t)from_mont(hi, q, qn), (u64)hi < (1ull << 31));
      }
    }
    __syncthreads();
    if (n >= a.N) continue;
    uint32_t lam[MAXC][2];
    const i64* xrow = a.x + (b * a.S + lo) * a.N + n;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      if (i < cnt) {
        const longlong2 v = *(const longlong2*)(xrow + (i64)i * a.N);
        if (a.hatinv) {
          const uint4 c = s_src[i];
          lam[i][0] = to_lam(v.x, c, a.hatinv + lo + i);
          lam[i][1] = to_lam(v.y, c, a.hatinv + lo + i);
        } else {
          lam[i][0] = (uint32_t)v.x;
          lam[i][1] = (uint32_t)v.y;
        }
      }
    }
    longlong2 kv = make_longlong2(0, 0);
    if (a.k) kv = *(const longlong2*)(a.k + b * a.N + n);
    i64* out = a.out + (bd * a.T) * a.N + n;
    for (int t0 = 0; t0 < a.T; t0 += kConvTile) {
      const uint4 q4 = *(const uint4*)(s_q + t0);
      const uint4 qn4 = *(const uint4*)(s_qn + t0);
      const uint32_t qs[kConvTile] = {q4.x, q4.y, q4.z, q4.w};
      const uint32_t qns[kConvTile] = {qn4.x, qn4.y, qn4.z, qn4.w};
      uint32_t res[kConvTile][2];
#pragma unroll
      for (int g0 = 0; g0 < MAXC; g0 += kLazy) {
        if (g0 < cnt) {
          u64 S[kConvTile][2] = {};
#pragma unroll
          for (int i = g0; i < g0 + kLazy && i < MAXC; ++i) {
            if (i < cnt) {
              const uint4 h4 = *(const uint4*)(s_hat + i * Tp + t0);
              const uint32_t h[kConvTile] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
              for (int j = 0; j < kConvTile; ++j) {
                S[j][0] += (u64)lam[i][0] * h[j];
                S[j][1] += (u64)lam[i][1] * h[j];
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kConvTile; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const uint32_t r = redc2_canon(S[j][c], qs[j], qns[j]);
              res[j][c] = g0 == 0 ? r : add_canon(res[j][c], r, qs[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kConvTile; ++j) {
        const int t = t0 + j;
        if (t < a.T) {
          uint32_t r0 = res[j][0], r1 = res[j][1];
          if (a.k) {
            const uint32_t q = qs[j], kq = s_kq[t];
            const uint32_t k0 = (uint32_t)mont_mul(kv.x, kq, q, qns[j]);
            const uint32_t k1 = (uint32_t)mont_mul(kv.y, kq, q, qns[j]);
            r0 = r0 >= k0 ? r0 - k0 : r0 + (q - k0);
            r1 = r1 >= k1 ? r1 - k1 : r1 + (q - k1);
          }
          *(longlong2*)(out + (i64)t * a.N) = make_longlong2(r0, r1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ks_mac: out[p, r, b, t, n] = sum_d y[b, d, t, src] * key_r[d, p, kl(t), n]
//         * 2^-32 mod tq[t], src = perm[r, n] (or n), kl(t) = t < split ? t
//         : t + kgap, for both key rows p
//
// A thread takes one (r, t, n): it loads the 2 D key values of its
// coefficient and perm[r, n] once, then walks the B rows of y, loading the
// next row's D digits before this row's arithmetic.  So each key element
// is read once per launch, whatever B is.  The grid's rows run over (t, r),
// r fastest, so the rotations of one target limb read its rows of y while
// they sit in L2.
// ---------------------------------------------------------------------------

constexpr int kMacThreads = 256;


__device__ __forceinline__ uint32_t load_key(const void* p, int is32, i64 off) {
  return is32 ? (uint32_t)((const int*)p)[off] : (uint32_t)((const i64*)p)[off];
}

// The canonical sums of both key rows' products, REDC'd in groups of four.
template <int MAXD>
__device__ __forceinline__ void mac_row(const uint32_t (&yv)[MAXD], const uint32_t (&k0)[MAXD],
                                        const uint32_t (&k1)[MAXD], int D, uint32_t q,
                                        uint32_t qn, uint32_t& acc0, uint32_t& acc1) {
  acc0 = acc1 = 0;
#pragma unroll
  for (int d0 = 0; d0 < MAXD; d0 += 4) {
    if (d0 < D) {
      u64 T0 = 0, T1 = 0;
#pragma unroll
      for (int d = d0; d < d0 + 4 && d < MAXD; ++d) {
        if (d < D) {
          T0 += (u64)yv[d] * k0[d];
          T1 += (u64)yv[d] * k1[d];
        }
      }
      acc0 = add_canon(acc0, redc_canon(T0, q, qn), q);
      acc1 = add_canon(acc1, redc_canon(T1, q, qn), q);
    }
  }
}

// Up to MAXD digits (a compile-time bound, so the key and y stay in
// registers); D <= MAXD at run time.
template <int MAXD>
__global__ void __launch_bounds__(kMacThreads) ks_mac(const __grid_constant__ KsMacArgs a) {
  const int n = blockIdx.x * kMacThreads + threadIdx.x;
  if (n >= a.N) return;
  const i64 plane = (i64)a.KL * a.N;
  const i64 dstep = (i64)a.T * a.N;           // one digit of y
  const i64 ystep = a.D * dstep;              // one row of y
  const i64 half = (i64)a.R * a.B * dstep;    // one key row's outputs
  for (int rt = blockIdx.y; rt < a.R * a.T; rt += gridDim.y) {
    const int t = rt / a.R, r = rt - t * a.R;
    const uint32_t q = (uint32_t)a.tq[t * a.tqs], qn = neg_qinv(q);
    const int src = a.perm ? (int)a.perm[(i64)r * a.N + n] : n;
    const int kl = t < a.split ? t : t + a.kgap;
    const void* key = a.key[r];
    const i64 koff = (i64)kl * a.N + n;
    uint32_t k0[MAXD], k1[MAXD], yv[MAXD];
    const i64* yp = a.y + (i64)t * a.N + src;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < a.D) {
        k0[d] = load_key(key, a.key32, (2 * d) * plane + koff);
        k1[d] = load_key(key, a.key32, (2 * d + 1) * plane + koff);
        yv[d] = (uint32_t)yp[d * dstep];
      }
    }
    i64* out = a.out + ((i64)r * a.B * a.T + t) * a.N + n;
    for (i64 b = 0; b < a.B; ++b) {
      uint32_t yn[MAXD];
      if (b + 1 < a.B) {
        const i64* ynp = yp + (b + 1) * ystep;
#pragma unroll
        for (int d = 0; d < MAXD; ++d)
          if (d < a.D) yn[d] = (uint32_t)ynp[d * dstep];
      }
      uint32_t acc0, acc1;
      mac_row<MAXD>(yv, k0, k1, a.D, q, qn, acc0, acc1);
      out[b * dstep] = acc0;
      out[half + b * dstep] = acc1;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) yv[d] = yn[d];
    }
  }
}

// ---------------------------------------------------------------------------
// diag_mac: out[b, l, n] = sum_j ct_j[b, l, n] * pt[j, l, n] * 2^-32 mod q[l]
// ---------------------------------------------------------------------------

constexpr int kDiagThreads = 256;


__global__ void __launch_bounds__(kDiagThreads) diag_mac(const __grid_constant__ DiagMacArgs a) {
  const int n = blockIdx.x * kDiagThreads + threadIdx.x;
  if (n >= a.N) return;
  for (int l = blockIdx.y; l < a.L; l += gridDim.y) {
    const uint32_t q = (uint32_t)a.q[l * a.qs], qn = neg_qinv(q);
    const i64 off = (i64)l * a.N + n;
    const i64 rows = (i64)a.L * a.N;
    uint32_t pt[kMaxTerms];
#pragma unroll
    for (int j = 0; j < kMaxTerms; ++j)
      if (j < a.terms) pt[j] = (uint32_t)a.pt[j * rows + off];
    for (i64 b = 0; b < a.B; ++b) {
      const i64 o = b * rows + off;
      uint32_t acc = 0;
#pragma unroll
      for (int j0 = 0; j0 < kMaxTerms; j0 += 4) {
        if (j0 < a.terms) {
          u64 T = 0;
#pragma unroll
          for (int j = j0; j < j0 + 4; ++j)
            if (j < a.terms) T += (u64)a.ct[j][o] * pt[j];
          acc = add_canon(acc, redc_canon(T, q, qn), q);
        }
      }
      a.out[o] = acc;
    }
  }
}

unsigned grid_rows(i64 rows) { return (unsigned)(rows < 65535 ? rows : 65535); }

}  // namespace

extern "C" {

int moai_limb_ew(const EwArgs* a, void* stream) {
  const i64 inner = a->size[a->ndim - 1];
  const dim3 grid((unsigned)((inner + kEwThreads * kEwVec - 1) / (kEwThreads * kEwVec)),
                  grid_rows(a->rows));
  limb_ew<<<grid, kEwThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int moai_base_conv(const BaseConvArgs* a, void* stream) {
  const int Tp = (a->T + kConvTile - 1) / kConvTile * kConvTile;
  const size_t smem = sizeof(uint32_t) * (size_t)Tp * (4 + a->A) + sizeof(uint4) * a->A;
  const dim3 grid((unsigned)((a->N + kConvCoeffs - 1) / kConvCoeffs), grid_rows(a->B * a->D));
  const cudaStream_t s = (cudaStream_t)stream;
  if (a->A <= 16) base_conv<16><<<grid, kConvThreads, smem, s>>>(*a);
  else base_conv<kMaxIn><<<grid, kConvThreads, smem, s>>>(*a);
  return (int)cudaGetLastError();
}

int moai_ks_mac(const KsMacArgs* a, void* stream) {
  const dim3 grid((unsigned)((a->N + kMacThreads - 1) / kMacThreads),
                  grid_rows((i64)a->R * a->T));
  const cudaStream_t s = (cudaStream_t)stream;
  if (a->D <= 2) ks_mac<2><<<grid, kMacThreads, 0, s>>>(*a);
  else if (a->D <= 4) ks_mac<4><<<grid, kMacThreads, 0, s>>>(*a);
  else if (a->D <= 8) ks_mac<8><<<grid, kMacThreads, 0, s>>>(*a);
  else ks_mac<kMaxDigits><<<grid, kMacThreads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

int moai_diag_mac(const DiagMacArgs* a, void* stream) {
  const dim3 grid((unsigned)((a->N + kDiagThreads - 1) / kDiagThreads), grid_rows(a->L));
  diag_mac<<<grid, kDiagThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// The sizes of the argument structs, which the Python side checks against
// its ctypes mirrors before the first launch.
int moai_limb_sizes(int* out) {
  out[0] = (int)sizeof(EwArgs);
  out[1] = (int)sizeof(BaseConvArgs);
  out[2] = (int)sizeof(KsMacArgs);
  out[3] = (int)sizeof(DiagMacArgs);
  return 0;
}

}  // extern "C"
