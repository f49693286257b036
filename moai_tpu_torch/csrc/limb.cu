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
// Residues are int32 lanes holding the JAX package's uint32 Montgomery
// values (x * 2^32 mod q, q an odd prime below 2^30).  Every kernel writes
// the canonical residue in [0, q), so it equals the torch ops it replaces
// (moai_tpu_torch/mod_arith.py, the *_plain functions) bit for bit.
//
// Bound: memory for limb_ew, ks_mac and diag_mac (each int32 input read
// once and each output written once at 3.35 TB/s; a few 32x32 -> 64-bit
// multiplies per element, far below the card's integer rate).  base_conv's
// decomposition, with up to 13 products and a two-step REDC per output,
// needs more INT32 issue slots than its 4-byte lanes need bytes: integer
// bound.  What the design does about it:
// - Reduction is Montgomery's REDC with R = 2^32 (one 32x32 low multiply,
//   one 32x32 -> 64 multiply-add, a shift), with no division on any
//   residue in range; -q^-1 mod 2^32 comes from four Newton steps on q,
//   once per row of a limb, so no table of it is read.
// - limb_ew takes a row's q (and -q^-1) once, moves four residues per
//   16-byte load and store, keeps two such loads of each operand in
//   flight, and reads an operand that is constant along a row once per
//   row.  Its inputs are int32 in [0, 2^31); a result past [0, 2q) (never
//   from canonical operands) takes a branch with the remainder.
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
// - diag_mac keeps a thread's 4 (or, past 8 terms, 2 or 1) coefficients of
//   every diagonal in registers (one 16-, 8- or 4-byte load each) and walks
//   the ciphertexts' rows, so each diagonal and each rotated ciphertext is
//   read once per giant step.
// - Loads are coalesced, consecutive threads on consecutive coefficients.

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
  const int* ptr;              // null: every element is `value`
  i64 value;
  i64 stride[kMaxDims];        // in elements, 0 along broadcast dims
};

struct EwArgs {
  Operand in[kOperands];
  int* out;                    // contiguous, the broadcast shape
  i64 size[kMaxDims];          // the collapsed shape, innermost last
  i64 rows;                    // product of all but the innermost size
  int ndim;
  int op;
};

struct BaseConvArgs {
  const int* x;                   // [B, S, N]
  const int* src_q;               // [S]
  const int* hatinv;              // [S] or null
  const int* hat;                 // hat[d * hs0 + a * hs1 + t * hs2]
  i64 hs0, hs1, hs2;
  const int* tq;                  // tq[t * tqs]
  i64 tqs;
  const int* k;                   // [B, N] or null
  const int* kq;                  // kq[t * kqs]
  i64 kqs;
  int* out;                       // [B, D, T, N]
  i64 B;
  int S, N, D, A, T;
};

struct KsMacArgs {
  const int* y;                   // [B, D, T, N]
  const i64* perm;                // [R, N] or null (R == 1)
  const int* key[kMaxRot];        // each [>= D, 2, rows, N], KL rows apart
  const int* tq;                  // tq[t * tqs]
  i64 tqs;
  int* out;                       // [2, R, B, T, N]
  i64 B;
  int KL, split, kgap;
  int R, D, T, N;
};

struct DiagMacArgs {
  const int* ct[kMaxTerms];       // each [B, L, N]
  const int* pt;                  // [terms, L, N]
  const int* q;                   // q[l * qs]
  i64 qs;
  int* out;                       // [B, L, N]
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

// t mod q for any t < 2^32: one subtract below 2q, else the remainder
// (never taken on canonical operands).
__device__ __forceinline__ uint32_t reduce(uint32_t t, uint32_t q) {
  t = t >= q ? t - q : t;
  return t < q ? t : t % q;
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
// limb_ew: out = op(a, b, c) mod q over the broadcast of its operands,
// each int32 in [0, 2^31); equal to the plain versions on that domain.
//
// A block takes a run of kEwSpan elements of one row (a run of the
// innermost collapsed dim, N coefficients of one limb on the scheme's
// paths) and walks the rows.  Per row it takes q and -q^-1 once, and
// reads an operand that is constant along the row (a per-limb or
// per-column constant, or a Python int) once.  Where the row is a
// multiple of four long, q is constant along it, and every other operand
// is contiguous along it from a 16-byte boundary, each thread moves four
// residues per 16-byte load and store, kEwVecs loads of each operand in
// flight; any other row takes the scalar path, with q (and -q^-1) per
// element where q varies along the row.
// ---------------------------------------------------------------------------

enum EwOp { kAdd = 0, kSub = 1, kNeg = 2, kMul = 3, kFromMont = 4, kSubMul = 5 };

constexpr int kEwThreads = 256;
constexpr int kEwVecs = 2;                            // 16-byte loads in flight
constexpr int kEwSpan = kEwThreads * kEwVecs * 4;     // elements of a block's run

// (x - y) mod q, floored, for x, y in [0, 2^31): canonical operands stay
// in the first line.
__device__ __forceinline__ uint32_t sub_mod(uint32_t x, uint32_t y, uint32_t q) {
  uint32_t d = x - y;
  if ((int)d < 0) d += q;
  if (d < q) return d;
  const i64 r = ((i64)x - (i64)y) % (i64)q;
  return (uint32_t)(r < 0 ? r + q : r);
}

// x * y * 2^-32 mod q, canonical, for x, y in [0, 2^31): one 32x32 -> 64
// product and one REDC (below 2^30 + q).
__device__ __forceinline__ uint32_t mont_mul(uint32_t x, uint32_t y, uint32_t q, uint32_t qn) {
  return reduce((uint32_t)redc((u64)x * y, q, qn), q);
}

template <int OP>
__device__ __forceinline__ uint32_t ew(uint32_t x, uint32_t y, uint32_t c, uint32_t q,
                                       uint32_t qn) {
  if constexpr (OP == kAdd) return reduce(x + y, q);
  if constexpr (OP == kSub) return sub_mod(x, y, q);
  if constexpr (OP == kNeg) return sub_mod(0u, x, q);
  if constexpr (OP == kMul) return mont_mul(x, y, q, qn);
  if constexpr (OP == kFromMont) return reduce((uint32_t)redc(x, q, qn), q);
  return mont_mul(sub_mod(x, y, q), c, q, qn);       // kSubMul
}

template <int OP>
__global__ void __launch_bounds__(kEwThreads) limb_ew(const __grid_constant__ EwArgs a) {
  constexpr int nin = OP == kNeg || OP == kFromMont ? 1 : OP == kSubMul ? 3 : 2;
  const int nd = a.ndim;
  const i64 inner = a.size[nd - 1];
  const bool q_row = !a.in[3].ptr || a.in[3].stride[nd - 1] == 0;
  const i64 run = (i64)blockIdx.x * kEwSpan;
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
    // the row's constants: q, -q^-1, and each operand constant along it
    uint32_t cst[kOperands];
    const int* p[3];
    bool vec = q_row && (inner & 3) == 0;
#pragma unroll
    for (int k = 0; k < kOperands; ++k) {
      const Operand& o = a.in[k];
      const bool along = o.ptr && o.stride[nd - 1] != 0;
      cst[k] = !o.ptr ? (uint32_t)o.value : along ? 0u : (uint32_t)o.ptr[base[k]];
      if (k < 3) {
        p[k] = along ? o.ptr + base[k] : nullptr;
        if (k < nin && along)
          vec = vec && o.stride[nd - 1] == 1 && ((uintptr_t)p[k] & 15) == 0;
      }
    }
    const uint32_t q = cst[3], qn = q_row ? neg_qinv(q) : 0u;
    int* out = a.out + row * inner;
    if (vec) {
      uint4 v[3][kEwVecs];
#pragma unroll
      for (int e = 0; e < kEwVecs; ++e) {
        const i64 j = run + (i64)(e * kEwThreads + threadIdx.x) * 4;
        if (j < inner) {
#pragma unroll
          for (int k = 0; k < nin; ++k)
            v[k][e] = p[k] ? *(const uint4*)(p[k] + j)
                           : make_uint4(cst[k], cst[k], cst[k], cst[k]);
        }
      }
#pragma unroll
      for (int e = 0; e < kEwVecs; ++e) {
        const i64 j = run + (i64)(e * kEwThreads + threadIdx.x) * 4;
        if (j < inner) {
          const uint4 x = v[0][e];
          const uint4 y = nin > 1 ? v[1][e] : x, c = nin > 2 ? v[2][e] : x;
          *(uint4*)(out + j) = make_uint4(ew<OP>(x.x, y.x, c.x, q, qn), ew<OP>(x.y, y.y, c.y, q, qn),
                                          ew<OP>(x.z, y.z, c.z, q, qn), ew<OP>(x.w, y.w, c.w, q, qn));
        }
      }
    } else {
      for (int e = 0; e < kEwVecs * 4; ++e) {
        const i64 j = run + e * kEwThreads + threadIdx.x;
        if (j >= inner) break;
        uint32_t v[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          v[k] = k < nin && p[k] ? (uint32_t)p[k][j * a.in[k].stride[nd - 1]] : cst[k];
        uint32_t qe = q, qne = qn;
        if (!q_row) {
          qe = (uint32_t)a.in[3].ptr[base[3] + j * a.in[3].stride[nd - 1]];
          qne = neg_qinv(qe);
        }
        out[j] = (int)ew<OP>(v[0], v[1], v[2], qe, qne);
      }
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
// block.  Outputs go out as one 8-byte store per target and thread.
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

// lam = from_mont(mont_mul(v, hatinv)) mod q, as the torch ops compute it:
// one REDC of v * (hatinv * 2^-32 mod q) (c.z), below 2q for any v in
// [0, 2^31).
__device__ __forceinline__ uint32_t to_lam(int v, uint4 c) {
  return redc_canon((u64)(uint32_t)v * c.z, c.x, c.y);
}

// k * w * 2^-32 mod q, canonical, for any int32 k (ModRaise's multiple of
// q0, negative k taken modulo q first) and w < q.
__device__ __forceinline__ uint32_t mont_mul_k(int k, uint32_t w, uint32_t q, uint32_t qn) {
  const uint32_t u = k >= 0 ? (uint32_t)k : (uint32_t)(k % (int)q + (int)q);
  return mont_mul(u, w, q, qn);
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
                                               // * 2^-32 (w unused)
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
        s_src[i] = make_uint4(q, qn, redc_canon((uint32_t)a.hatinv[lo + i], q, qn), 0u);
      }
    }
    __syncthreads();
    if (n >= a.N) continue;
    uint32_t lam[MAXC][2];
    const int* xrow = a.x + (b * a.S + lo) * a.N + n;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      if (i < cnt) {
        const int2 v = *(const int2*)(xrow + (i64)i * a.N);
        if (a.hatinv) {
          const uint4 c = s_src[i];
          lam[i][0] = to_lam(v.x, c);
          lam[i][1] = to_lam(v.y, c);
        } else {
          lam[i][0] = (uint32_t)v.x;
          lam[i][1] = (uint32_t)v.y;
        }
      }
    }
    int2 kv = make_int2(0, 0);
    if (a.k) kv = *(const int2*)(a.k + b * a.N + n);
    int* out = a.out + (bd * a.T) * a.N + n;
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
            const uint32_t k0 = mont_mul_k(kv.x, kq, q, qns[j]);
            const uint32_t k1 = mont_mul_k(kv.y, kq, q, qns[j]);
            r0 = r0 >= k0 ? r0 - k0 : r0 + (q - k0);
            r1 = r1 >= k1 ? r1 - k1 : r1 + (q - k1);
          }
          *(int2*)(out + (i64)t * a.N) = make_int2((int)r0, (int)r1);
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
    const int* key = a.key[r];
    const i64 koff = (i64)kl * a.N + n;
    uint32_t k0[MAXD], k1[MAXD], yv[MAXD];
    const int* yp = a.y + (i64)t * a.N + src;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < a.D) {
        k0[d] = (uint32_t)key[(2 * d) * plane + koff];
        k1[d] = (uint32_t)key[(2 * d + 1) * plane + koff];
        yv[d] = (uint32_t)yp[d * dstep];
      }
    }
    int* out = a.out + ((i64)r * a.B * a.T + t) * a.N + n;
    for (i64 b = 0; b < a.B; ++b) {
      uint32_t yn[MAXD];
      if (b + 1 < a.B) {
        const int* ynp = yp + (b + 1) * ystep;
#pragma unroll
        for (int d = 0; d < MAXD; ++d)
          if (d < a.D) yn[d] = (uint32_t)ynp[d * dstep];
      }
      uint32_t acc0, acc1;
      mac_row<MAXD>(yv, k0, k1, a.D, q, qn, acc0, acc1);
      out[b * dstep] = (int)acc0;
      out[half + b * dstep] = (int)acc1;
#pragma unroll
      for (int d = 0; d < MAXD; ++d) yv[d] = yn[d];
    }
  }
}

// ---------------------------------------------------------------------------
// diag_mac: out[b, l, n] = sum_j ct_j[b, l, n] * pt[j, l, n] * 2^-32 mod q[l]
//
// A block row is one limb l (its q and -q^-1 taken once).  A thread owns V
// consecutive coefficients: it loads them from each of the launch's
// diagonals once, as one 8- or 16-byte vector, and keeps them in
// registers while it walks the B ciphertext rows, loading each row's V
// coefficients of every term before the arithmetic.  The term count is a
// compile-time bound (MAXJ terms x V lanes of diagonals in registers): up
// to 8 terms take 4 coefficients, up to 16 take 2, up to 32 take 1.
// ---------------------------------------------------------------------------

constexpr int kDiagThreads = 128;

template <int V>
struct Lanes {
  uint32_t v[V];
};

template <int V>
__device__ __forceinline__ Lanes<V> load_lanes(const int* p) {
  Lanes<V> r;
  if constexpr (V == 4) {
    const uint4 t = *(const uint4*)p;
    r.v[0] = t.x, r.v[1] = t.y, r.v[2] = t.z, r.v[3] = t.w;
  } else if constexpr (V == 2) {
    const uint2 t = *(const uint2*)p;
    r.v[0] = t.x, r.v[1] = t.y;
  } else {
    r.v[0] = (uint32_t)*p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_lanes(int* p, const uint32_t (&v)[V]) {
  if constexpr (V == 4)
    *(uint4*)p = make_uint4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *(uint2*)p = make_uint2(v[0], v[1]);
  else
    *p = (int)v[0];
}

template <int MAXJ, int V>
__global__ void __launch_bounds__(kDiagThreads) diag_mac(const __grid_constant__ DiagMacArgs a) {
  const int n = (blockIdx.x * kDiagThreads + threadIdx.x) * V;
  if (n >= a.N) return;
  const i64 rows = (i64)a.L * a.N;
  for (int l = blockIdx.y; l < a.L; l += gridDim.y) {
    const uint32_t q = (uint32_t)a.q[l * a.qs], qn = neg_qinv(q);
    const i64 off = (i64)l * a.N + n;
    Lanes<V> pt[MAXJ];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j < a.terms) pt[j] = load_lanes<V>(a.pt + j * rows + off);
    for (i64 b = 0; b < a.B; ++b) {
      const i64 o = b * rows + off;
      Lanes<V> ct[MAXJ];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j)
        if (j < a.terms) ct[j] = load_lanes<V>(a.ct[j] + o);
      uint32_t acc[V];
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] = 0;
#pragma unroll
      for (int j0 = 0; j0 < MAXJ; j0 += 4) {
        if (j0 < a.terms) {
          u64 T[V];
#pragma unroll
          for (int c = 0; c < V; ++c) T[c] = 0;
#pragma unroll
          for (int j = j0; j < j0 + 4 && j < MAXJ; ++j) {
            if (j < a.terms) {
#pragma unroll
              for (int c = 0; c < V; ++c) T[c] += (u64)ct[j].v[c] * pt[j].v[c];
            }
          }
#pragma unroll
          for (int c = 0; c < V; ++c) acc[c] = add_canon(acc[c], redc_canon(T[c], q, qn), q);
        }
      }
      store_lanes<V>(a.out + o, acc);
    }
  }
}

unsigned grid_rows(i64 rows) { return (unsigned)(rows < 65535 ? rows : 65535); }

}  // namespace

extern "C" {

int moai_limb_ew(const EwArgs* a, void* stream) {
  const i64 inner = a->size[a->ndim - 1];
  const dim3 grid((unsigned)((inner + kEwSpan - 1) / kEwSpan), grid_rows(a->rows));
  const cudaStream_t s = (cudaStream_t)stream;
  switch (a->op) {
    case kAdd: limb_ew<kAdd><<<grid, kEwThreads, 0, s>>>(*a); break;
    case kSub: limb_ew<kSub><<<grid, kEwThreads, 0, s>>>(*a); break;
    case kNeg: limb_ew<kNeg><<<grid, kEwThreads, 0, s>>>(*a); break;
    case kMul: limb_ew<kMul><<<grid, kEwThreads, 0, s>>>(*a); break;
    case kFromMont: limb_ew<kFromMont><<<grid, kEwThreads, 0, s>>>(*a); break;
    case kSubMul: limb_ew<kSubMul><<<grid, kEwThreads, 0, s>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
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
  const int V = a->terms <= 8 ? 4 : a->terms <= 16 ? 2 : 1;
  const dim3 grid((unsigned)((a->N / V + kDiagThreads - 1) / kDiagThreads), grid_rows(a->L));
  const cudaStream_t s = (cudaStream_t)stream;
  if (a->terms <= 8) diag_mac<8, 4><<<grid, kDiagThreads, 0, s>>>(*a);
  else if (a->terms <= 16) diag_mac<16, 2><<<grid, kDiagThreads, 0, s>>>(*a);
  else diag_mac<kMaxTerms, 1><<<grid, kDiagThreads, 0, s>>>(*a);
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
