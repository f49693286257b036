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
// multiplies per element, far below the card's integer rate.  What the
// design does about it:
// - Reduction is Montgomery's REDC with R = 2^32 (one 32x32 low multiply,
//   one 32x32 -> 64 multiply-add, a shift), with no division on any
//   residue in range; -q^-1 mod 2^32 comes from four Newton steps on q, so
//   no table of it is read.  The elementwise ops take any int64 input, as
//   the torch ops do: operands past the residues' range (never on the
//   scheme's paths) take a branch with the int64 remainder.
// - The MACs add up to four products of residues in 64 bits (each below
//   2^30 * q, four below q * 2^32, REDC's input range) before one REDC,
//   and keep a canonical 32-bit sum across groups.
// - base_conv reads each input limb once per output tile: a thread keeps
//   its coefficient's alpha (or K) converted inputs in registers and walks
//   every target limb; the table hat[a][t] sits in shared memory.
// - ks_mac reads each digit of y once for both key rows, reads the key
//   where it lies (no copy of the active limbs), and gathers y through a
//   rotation's permutation instead of materialising the rotated digits.
// - diag_mac keeps a coefficient's diagonals in registers and walks the
//   ciphertexts' rows, so each diagonal and each rotated ciphertext is read
//   once per giant step.
// - Loads are coalesced 8-byte loads, consecutive threads on consecutive
//   coefficients; each elementwise thread keeps four loads in flight.

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
// ---------------------------------------------------------------------------

constexpr int kConvThreads = 256;


__global__ void __launch_bounds__(kConvThreads) base_conv(const __grid_constant__ BaseConvArgs a) {
  extern __shared__ uint32_t sm[];
  uint32_t* s_q = sm;
  uint32_t* s_qn = s_q + a.T;
  uint32_t* s_kq = s_qn + a.T;
  uint32_t* s_hat = s_kq + a.T;   // [A][T]
  const int n = blockIdx.x * kConvThreads + threadIdx.x;
  for (i64 bd = blockIdx.y; bd < a.B * a.D; bd += gridDim.y) {
    const int d = (int)(bd % a.D);
    const i64 b = bd / a.D;
    const int lo = d * a.A;
    const int cnt = min(a.A, a.S - lo);
    __syncthreads();              // the previous row's readers are done
    for (int i = threadIdx.x; i < a.T; i += kConvThreads) {
      const uint32_t q = (uint32_t)a.tq[i * a.tqs];
      s_q[i] = q;
      s_qn[i] = neg_qinv(q);
      s_kq[i] = a.k ? (uint32_t)a.kq[i * a.kqs] : 0u;
    }
    for (int i = threadIdx.x; i < cnt * a.T; i += kConvThreads) {
      const int ai = i / a.T, t = i - ai * a.T;
      s_hat[i] = (uint32_t)a.hat[d * a.hs0 + ai * a.hs1 + t * a.hs2];
    }
    __syncthreads();
    if (n >= a.N) continue;
    uint32_t lam[kMaxIn];
#pragma unroll
    for (int i = 0; i < kMaxIn; ++i) {
      if (i < cnt) {
        const i64 v = a.x[(b * a.S + lo + i) * a.N + n];
        if (a.hatinv) {
          const uint32_t qi = (uint32_t)a.src_q[lo + i], qni = neg_qinv(qi);
          lam[i] = (uint32_t)from_mont(mont_mul(v, a.hatinv[lo + i], qi, qni), qi, qni);
        } else {
          lam[i] = (uint32_t)v;
        }
      }
    }
    const i64 kv = a.k ? a.k[b * a.N + n] : 0;
    i64* out = a.out + (bd * a.T) * a.N + n;
    for (int t = 0; t < a.T; ++t) {
      const uint32_t q = s_q[t], qn = s_qn[t];
      uint32_t acc = 0;
#pragma unroll
      for (int i = 0; i < kMaxIn; i += 4) {
        if (i < cnt) {
          u64 T = 0;
#pragma unroll
          for (int j = i; j < i + 4; ++j)
            if (j < cnt) T += (u64)lam[j] * s_hat[j * a.T + t];
          acc = add_canon(acc, redc_canon(T, q, qn), q);
        }
      }
      if (a.k) {
        const uint32_t kt = (uint32_t)mont_mul(kv, s_kq[t], q, qn);
        acc = acc >= kt ? acc - kt : acc + (q - kt);
      }
      out[(i64)t * a.N] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// ks_mac: out[p, r, b, t, n] = sum_d y[b, d, t, src] * key_r[d, p, kl(t), n]
//         * 2^-32 mod tq[t], src = perm[r, n] (or n), kl(t) = t < split ? t
//         : t + kgap, for both key rows p
// ---------------------------------------------------------------------------

constexpr int kMacThreads = 256;


__device__ __forceinline__ i64 load_key(const void* p, int is32, i64 off) {
  return is32 ? (i64)((const int*)p)[off] : ((const i64*)p)[off];
}

__global__ void __launch_bounds__(kMacThreads) ks_mac(const __grid_constant__ KsMacArgs a) {
  const int n = blockIdx.x * kMacThreads + threadIdx.x;
  if (n >= a.N) return;
  const i64 plane = (i64)a.KL * a.N;
  for (i64 row = blockIdx.y; row < (i64)a.R * a.B * a.T; row += gridDim.y) {
    const int t = (int)(row % a.T);
    const i64 rb = row / a.T;
    const int r = (int)(rb / a.B);
    const i64 b = rb - (i64)r * a.B;
    const uint32_t q = (uint32_t)a.tq[t * a.tqs], qn = neg_qinv(q);
    const int src = a.perm ? (int)a.perm[(i64)r * a.N + n] : n;
    const int kl = t < a.split ? t : t + a.kgap;
    const void* key = a.key[r];
    const i64* yrow = a.y + (b * a.D * a.T + t) * a.N + src;
    const i64 koff = (i64)kl * a.N + n;
    uint32_t acc0 = 0, acc1 = 0;
    for (int d0 = 0; d0 < a.D; d0 += 4) {
      u64 T0 = 0, T1 = 0;
#pragma unroll
      for (int d = d0; d < d0 + 4; ++d) {
        if (d < a.D) {
          const u64 yv = (u64)yrow[(i64)d * a.T * a.N];
          T0 += yv * (u64)load_key(key, a.key32, (2 * d) * plane + koff);
          T1 += yv * (u64)load_key(key, a.key32, (2 * d + 1) * plane + koff);
        }
      }
      acc0 = add_canon(acc0, redc_canon(T0, q, qn), q);
      acc1 = add_canon(acc1, redc_canon(T1, q, qn), q);
    }
    const i64 o = (rb * a.T + t) * a.N + n;
    a.out[o] = acc0;
    a.out[(i64)a.R * a.B * a.T * a.N + o] = acc1;
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
  const size_t smem = sizeof(uint32_t) * (size_t)a->T * (3 + a->A);
  const dim3 grid((unsigned)((a->N + kConvThreads - 1) / kConvThreads), grid_rows(a->B * a->D));
  base_conv<<<grid, kConvThreads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int moai_ks_mac(const KsMacArgs* a, void* stream) {
  const dim3 grid((unsigned)((a->N + kMacThreads - 1) / kMacThreads),
                  grid_rows((i64)a->R * a->B * a->T));
  ks_mac<<<grid, kMacThreads, 0, (cudaStream_t)stream>>>(*a);
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
