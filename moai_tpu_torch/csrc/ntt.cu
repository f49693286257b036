// Forward and inverse negacyclic NTT over RNS limbs, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of moai_tpu/pallas_ntt.py:
//   moai_ntt_fwd  <- _fwd_kernel (pallas_ntt.py:282), reached via ntt_pallas
//   moai_ntt_inv  <- _inv_kernel (pallas_ntt.py:301), reached via intt_pallas
// Each entry point launches two device kernels (two passes over the row).
// Contract (that of moai_tpu.ntt.ntt/intt): each row of N residues is in
// Montgomery form (x*2^32 mod q, q < 2^30), held in an int32 lane; the
// forward output index k holds the evaluation at root exponent 2k+1 of the
// limb's psi (natural order); the Montgomery factor is preserved; the
// inverse includes 1/N.  Every output is the canonical residue, so the
// result is bit-identical to any other exact NTT with the same psi.
//
// Bound: memory.  Each residue is read once and written once as int32
// (8 bytes); the two passes add a uint32 scratch written and read once
// (8 bytes), so a perfect two-pass kernel moves 16 bytes per element and
// reaches at most half of the 8-byte bound.  The per-element twiddle
// tables (8 bytes per element per limb) are shared by every row of a limb
// and stay in the 50 MB L2.
//
// Design: the 4-step factorization of moai_tpu_torch/ntt.py (ntt_plain),
// N = n1 * n2 with n1, n2 = _split(N) (128 x 256 at 2^15, 256 x 256 at
// 2^16), one code path for every N from 2^9 to 2^16, no clusters:
//   x[j1*n2 + j2] -> Y[k2*n1 + k1] = sum psi^((2k+1)j)
//     = sum_j2 w^(k2 j2) psi^((2k1+1) j2) sum_j1 psi1^((2k1+1) j1) x[j1, j2]
//   with psi1 = psi^n2 and w = psi^(2 n1).
// - Forward pass 1 (ntt_cols<false>): one block per (row, 32 consecutive
//   columns j2); each column is an n1-point negacyclic NTT with psi1 (the
//   twist psi^(j1 n2) folded into it), then the mid twiddle
//   psi^((2k1+1) j2) (the twist psi^j2 folded into it), written to a
//   uint32 scratch [row, k1, j2] in natural k1 order.
// - Forward pass 2 (ntt_rows<false>): one block per (row, 32 consecutive
//   k1); each is an n2-point cyclic NTT with root w, written to output
//   index k2*n1 + k1 (32 contiguous int32 per k2).
// - The inverse mirrors it with the same two templates: pass 1
//   (ntt_rows<true>) runs the inverse cyclic transforms over k2 and
//   multiplies by psi^-((2k1+1) j2) / N (untwist and 1/N folded into the
//   mid table); pass 2 (ntt_cols<true>) runs the inverse negacyclic
//   n1-point transforms with psi1^-1.
// - A tile is [n][33] uint32 in shared memory (32 transforms side by side,
//   one padding word per point so that loads along either axis are free
//   of bank conflicts): at most 36 KB, so several blocks share an SM.
//   The small transforms' twiddles (n <= 256 entries per limb, each with
//   its Shoup companion) are copied into shared memory once per block.
// - Butterflies run in registers: a thread takes 16 points of one
//   transform and does 4 radix-2 stages between barriers (an 8-stage
//   transform needs 2 barriers).  Forward passes are Cooley-Tukey on
//   natural input with bit-reversed output (table index m+i of stage m,
//   block i); the inverse passes are Gentleman-Sande on bit-reversed input
//   with the inverse twiddles.
// - Twiddles are plain residues with Shoup companions (__umulhi): a plain
//   multiplier keeps the data's Montgomery factor.  Butterflies reduce
//   lazily (Harvey): between stages a value lies in [0, 4q) (forward) or
//   [0, 2q) (inverse), below 2^32 since q < 2^30, and the last pass makes
//   it canonical.  The TPU kernel's int8-digit matrix form and its
//   16-bit-halves multiplies emulate a widening multiply that Hopper has
//   natively, so none of that is carried over.
// - Tile loads and stores are batched, 16 per thread in flight, so that
//   enough bytes are in flight to cover the latency of device memory.
// - Blocks run limb-major (every row of one limb, then the next limb), so
//   that the blocks in flight share a few limbs' mid tables, which stay in
//   L2 even when all the tables do not (87 limbs at 2^16 are 46 MB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLogTile = 5;   // 32 transforms per block
constexpr int kMaxThreads = 256;
constexpr int kRadixLog = 4;     // stages per barrier
constexpr int kUnroll = 16;      // loads in flight per thread

// x * w mod q up to one q, in [0, 2q), for any x < 2^32 and a
// precomputed w < q with companion ws = floor(w * 2^32 / q); the
// products wrap mod 2^32.
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint2 w, uint32_t q) {
  return x * w.x - __umulhi(x, w.y) * q;
}

// x * w mod q, canonical.  min(r, r - q) is r mod q for r < 2q: r - q
// wraps above r when r < q.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint2 w, uint32_t q) {
  const uint32_t r = shoup_lazy(x, w, q);
  return min(r, r - q);
}

__device__ __forceinline__ int brev(int k, int log_n) {
  return (int)(__brev((unsigned)k) >> (32 - log_n));
}

// One pass of R radix-2 stages, s0 .. s0+R-1, over 2^log_p transforms of
// n = 2^log_n points held in a[j * (2^log_p + 1) + c].  A group is the 2^R
// points of one transform that these stages connect: those whose index
// bits [b_lo, b_lo + R) vary, b_lo = log_n - s0 - R.  Stage s = s0 + l
// pairs local points k, k + 2^(R-1-l), in block i = (i0 << l) | (k >> (R-l))
// of that stage, with twiddle tw[2^s + i].
template <int R, bool kInverse>
__device__ __forceinline__ void radix_pass(uint32_t* a, int log_n, int log_p, int s0,
                                           const uint2* tw, uint32_t q) {
  constexpr int K = 1 << R;
  const int stride = (1 << log_p) + 1;
  const int b_lo = log_n - s0 - R;
  const int groups = 1 << (log_n - R + log_p);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int c = g & ((1 << log_p) - 1);
    const int grp = g >> log_p;
    const int i0 = grp >> b_lo;
    const int base = ((i0 << (b_lo + R)) | (grp & ((1 << b_lo) - 1))) * stride + c;
    const int step = stride << b_lo;
    uint32_t v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = a[base + k * step];
    if constexpr (!kInverse) {
#pragma unroll
      for (int l = 0; l < R; ++l) {
        const int half = K >> (l + 1);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k & half) continue;
          const uint2 w = tw[(1 << (s0 + l)) + (i0 << l) + (k >> (R - l))];
          // in [0, 4q): u to [0, 2q), t in [0, 2q), outputs in [0, 4q)
          const uint32_t u = min(v[k], v[k] - 2 * q);
          const uint32_t t = shoup_lazy(v[k + half], w, q);
          v[k] = u + t;
          v[k + half] = u - t + 2 * q;
        }
      }
      if (s0 + R == log_n) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const uint32_t u = min(v[k], v[k] - 2 * q);
          v[k] = min(u, u - q);
        }
      }
    } else {
#pragma unroll
      for (int l = R - 1; l >= 0; --l) {
        const int half = K >> (l + 1);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k & half) continue;
          const uint2 w = tw[(1 << (s0 + l)) + (i0 << l) + (k >> (R - l))];
          // in [0, 2q), outputs in [0, 2q)
          const uint32_t u = v[k];
          const uint32_t t = v[k + half];
          const uint32_t s = u + t;
          v[k] = min(s, s - 2 * q);
          v[k + half] = shoup_lazy(u - t + 2 * q, w, q);
        }
      }
      if (s0 == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = min(v[k], v[k] - q);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) a[base + k * step] = v[k];
  }
}

template <bool kInverse>
__device__ __forceinline__ void run_pass(uint32_t* a, int log_n, int log_p, int s0, int r,
                                         const uint2* tw, uint32_t q) {
  if (r == 4)
    radix_pass<4, kInverse>(a, log_n, log_p, s0, tw, q);
  else if (r == 3)
    radix_pass<3, kInverse>(a, log_n, log_p, s0, tw, q);
  else if (r == 2)
    radix_pass<2, kInverse>(a, log_n, log_p, s0, tw, q);
  else
    radix_pass<1, kInverse>(a, log_n, log_p, s0, tw, q);
  __syncthreads();
}

// All log_n stages, kRadixLog per barrier: Cooley-Tukey passes at
// s0 = 0, 4, 8, ... (natural in, bit-reversed out) ...
__device__ void ct_transform(uint32_t* a, int log_n, int log_p, const uint2* tw,
                             uint32_t q) {
  for (int s0 = 0; s0 < log_n; s0 += kRadixLog)
    run_pass<false>(a, log_n, log_p, s0, min(kRadixLog, log_n - s0), tw, q);
}

// ... and their Gentleman-Sande inverses in reverse order (bit-reversed in,
// natural out), without the 1/n factor.
__device__ void gs_transform(uint32_t* a, int log_n, int log_p, const uint2* tw,
                             uint32_t q) {
  for (int s0 = (log_n - 1) / kRadixLog * kRadixLog; s0 >= 0; s0 -= kRadixLog)
    run_pass<true>(a, log_n, log_p, s0, min(kRadixLog, log_n - s0), tw, q);
}

// Moves total words of a tile, thread t taking e = t + u * blockDim.x: the
// kUnroll loads of a batch are all issued before its first store.  The
// launch makes total a multiple of kUnroll * blockDim.x.
template <typename Load, typename Store>
__device__ __forceinline__ void move_tile(int total, Load load, Store store) {
  for (int e0 = threadIdx.x; e0 < total; e0 += kUnroll * blockDim.x) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load(e0 + u * blockDim.x);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) store(e0 + u * blockDim.x, v[u]);
  }
}

// Shared memory of a block: the n twiddles (uint2), then the [n][p+1] tile.
__device__ __forceinline__ uint32_t* load_twiddles(uint2* tw, const uint2* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) tw[i] = src[i];
  return reinterpret_cast<uint32_t*>(tw + n);
}

// A block's row, limb and first transform: blockIdx.x = (limb * batches +
// b) * tiles + tile for row b * limbs + limb, so blocks run limb-major.
struct Block {
  size_t row;
  int limb, first;
};

__device__ __forceinline__ Block block_of(int log_tiles, int log_p, int limbs) {
  const size_t rb = blockIdx.x >> log_tiles;
  const size_t batches = ((size_t)gridDim.x >> log_tiles) / limbs;
  const int limb = (int)(rb / batches);
  return {(rb % batches) * limbs + limb, limb,
          (int)(blockIdx.x & ((1u << log_tiles) - 1)) << log_p};
}

struct Geometry {
  int log_n1, log_n2, log_p;  // log_p: log2 of the transforms per block
  int limbs;
};

// Columns pass: the n1-point negacyclic transforms of columns j2_0 ..
// j2_0 + p of one row.  Forward (pass 1): int32 x -> Cooley-Tukey -> times
// the mid twiddle -> uint32 scratch, rows in natural k1 order.  Inverse
// (pass 2): uint32 scratch -> Gentleman-Sande -> int32 y.
template <bool kInverse, typename In, typename Out>
__global__ void __launch_bounds__(kMaxThreads)
    ntt_cols(const In* __restrict__ src, Out* __restrict__ dst, Geometry g,
             const uint32_t* __restrict__ q_tab, const uint2* __restrict__ tw_tab,
             const uint2* __restrict__ mid_tab) {
  extern __shared__ uint2 smem[];
  const int n2 = 1 << g.log_n2, p = 1 << g.log_p, stride = p + 1;
  const int log_n = g.log_n1 + g.log_n2;
  const Block blk = block_of(g.log_n2 - g.log_p, g.log_p, g.limbs);
  const uint32_t q = q_tab[blk.limb];
  uint32_t* a = load_twiddles(smem, tw_tab + ((size_t)blk.limb << g.log_n1), 1 << g.log_n1);
  const size_t off = (blk.row << log_n) + blk.first;
  const In* sr = src + off;
  Out* dr = dst + off;
  // e = i * p + c: point i of column c, at i * n2 + c of the row on either
  // side; the tile holds the natural side (j1 = i) at position i and the
  // spectral side (k1 = i) at position brev(i)
  auto nat = [&](int e) { return e + (e >> g.log_p); };  // i * stride + c
  auto spec = [&](int e) { return brev(e >> g.log_p, g.log_n1) * stride + (e & (p - 1)); };
  auto glob = [&](int e) { return (e >> g.log_p) * n2 + (e & (p - 1)); };
  const int words = 1 << (g.log_n1 + g.log_p);
  move_tile(
      words, [&](int e) { return (uint32_t)sr[glob(e)]; },
      [&](int e, uint32_t v) { a[kInverse ? spec(e) : nat(e)] = v; });
  __syncthreads();
  if constexpr (kInverse)
    gs_transform(a, g.log_n1, g.log_p, smem, q);
  else
    ct_transform(a, g.log_n1, g.log_p, smem, q);
  const uint2* mid = mid_tab + ((size_t)blk.limb << log_n) + blk.first;
  move_tile(
      words,
      [&](int e) {
        const uint32_t v = a[kInverse ? nat(e) : spec(e)];
        if constexpr (kInverse)
          return v;
        else
          return shoup_mul(v, mid[glob(e)], q);
      },
      [&](int e, uint32_t v) { dr[glob(e)] = (Out)v; });
}

// Rows pass: the n2-point cyclic transforms of scratch rows k1_0 .. k1_0 +
// p of one row.  Forward (pass 2): uint32 scratch -> Cooley-Tukey -> int32
// y at k2 * n1 + k1.  Inverse (pass 1): int32 x at k2 * n1 + k1 ->
// Gentleman-Sande -> times the inverse mid twiddle -> uint32 scratch.
template <bool kInverse, typename In, typename Out>
__global__ void __launch_bounds__(kMaxThreads)
    ntt_rows(const In* __restrict__ src, Out* __restrict__ dst, Geometry g,
             const uint32_t* __restrict__ q_tab, const uint2* __restrict__ tw_tab,
             const uint2* __restrict__ mid_tab) {
  extern __shared__ uint2 smem[];
  const int n1 = 1 << g.log_n1, n2 = 1 << g.log_n2, p = 1 << g.log_p, stride = p + 1;
  const int log_n = g.log_n1 + g.log_n2;
  const Block blk = block_of(g.log_n1 - g.log_p, g.log_p, g.limbs);
  const uint32_t q = q_tab[blk.limb];
  uint32_t* a = load_twiddles(smem, tw_tab + ((size_t)blk.limb << g.log_n2), n2);
  // scratch side, e = r * n2 + j2: the block's p scratch rows are
  // contiguous; the tile holds j2 at position j2
  const size_t s_off = (blk.row << log_n) + ((size_t)blk.first << g.log_n2);
  auto s_at = [&](int e) { return (e & (n2 - 1)) * stride + (e >> g.log_n2); };
  // spectral side, e = k2 * p + r: p contiguous int32 at k2 * n1 + k1_0;
  // the tile holds k2 at position brev(k2)
  const size_t y_off = (blk.row << log_n) + blk.first;
  auto y_at = [&](int e) { return brev(e >> g.log_p, g.log_n2) * stride + (e & (p - 1)); };
  auto y_glob = [&](int e) { return (e >> g.log_p) * n1 + (e & (p - 1)); };
  const int words = 1 << (g.log_n2 + g.log_p);
  if constexpr (kInverse) {
    const In* xr = src + y_off;
    uint32_t* sr = dst + s_off;
    move_tile(
        words, [&](int e) { return (uint32_t)xr[y_glob(e)]; },
        [&](int e, uint32_t v) { a[y_at(e)] = v; });
    __syncthreads();
    gs_transform(a, g.log_n2, g.log_p, smem, q);
    const uint2* mid = mid_tab + ((size_t)blk.limb << log_n) + ((size_t)blk.first << g.log_n2);
    move_tile(
        words, [&](int e) { return shoup_mul(a[s_at(e)], mid[e], q); },
        [&](int e, uint32_t v) { sr[e] = v; });
  } else {
    const uint32_t* sr = src + s_off;
    Out* yr = dst + y_off;
    move_tile(
        words, [&](int e) { return sr[e]; },
        [&](int e, uint32_t v) { a[s_at(e)] = v; });
    __syncthreads();
    ct_transform(a, g.log_n2, g.log_p, smem, q);
    move_tile(
        words, [&](int e) { return a[y_at(e)]; },
        [&](int e, uint32_t v) { yr[y_glob(e)] = (Out)v; });
  }
}

struct Launch {
  Geometry g;
  unsigned blocks;
  int threads;
  size_t smem;
};

// Tiles of p = 2^min(5, log_n_tiled) transforms of 2^log_n points each;
// log_n_tiled is the axis the tiles are cut from.
int plan(long long rows, int limbs, int log_n, bool transforms_cols, Launch* l) {
  const int log_n1 = log_n / 2, log_n2 = log_n - log_n1;
  const int log_tiled = transforms_cols ? log_n2 : log_n1;
  const int log_len = transforms_cols ? log_n1 : log_n2;
  const int log_p = log_tiled < kMaxLogTile ? log_tiled : kMaxLogTile;
  l->g = Geometry{log_n1, log_n2, log_p, limbs};
  const long long blocks = rows << (log_tiled - log_p);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  l->blocks = (unsigned)blocks;
  // threads: at most 1/kUnroll of the tile's words (so that move_tile's
  // batches divide it), at most kMaxThreads
  const int words = 1 << (log_len + log_p);
  l->threads = words / kUnroll < kMaxThreads ? words / kUnroll : kMaxThreads;
  l->smem = ((size_t)1 << log_len) * (sizeof(uint2) + ((1 << log_p) + 1) * sizeof(uint32_t));
  return l->smem <= 48 * 1024 ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: [rows, n] int32, row r holds limb r % limbs; scratch: [rows, n]
// uint32.  Tables are offset to the first active limb: q [limbs], tw_cols
// [limbs, n1], mid [limbs, n1, n2], tw_rows [limbs, n2], each uint2 entry
// a (twiddle, Shoup companion) pair.  Returns the first CUDA error.
extern "C" int moai_ntt_fwd(const int32_t* x, int32_t* y, uint32_t* scratch, long long rows,
                            int limbs, int log_n, const uint32_t* q, const uint2* tw_cols,
                            const uint2* mid, const uint2* tw_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Launch l;
  int err = plan(rows, limbs, log_n, true, &l);
  if (err) return err;
  ntt_cols<false><<<l.blocks, l.threads, l.smem, st>>>(x, scratch, l.g, q, tw_cols, mid);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = plan(rows, limbs, log_n, false, &l))) return err;
  ntt_rows<false><<<l.blocks, l.threads, l.smem, st>>>(
      (const uint32_t*)scratch, y, l.g, q, tw_rows, nullptr);
  return (int)cudaGetLastError();
}

// The inverse: tw_rows and mid_inv (psi^-((2k1+1) j2) / N) for pass 1,
// tw_cols (psi1^-bitrev) for pass 2.
extern "C" int moai_ntt_inv(const int32_t* x, int32_t* y, uint32_t* scratch, long long rows,
                            int limbs, int log_n, const uint32_t* q, const uint2* tw_rows,
                            const uint2* mid_inv, const uint2* tw_cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Launch l;
  int err = plan(rows, limbs, log_n, false, &l);
  if (err) return err;
  ntt_rows<true><<<l.blocks, l.threads, l.smem, st>>>(x, scratch, l.g, q, tw_rows, mid_inv);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = plan(rows, limbs, log_n, true, &l))) return err;
  ntt_cols<true><<<l.blocks, l.threads, l.smem, st>>>(
      (const uint32_t*)scratch, y, l.g, q, tw_cols, nullptr);
  return (int)cudaGetLastError();
}
