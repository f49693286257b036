// Forward and inverse negacyclic NTT over RNS limbs, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of moai_tpu/pallas_ntt.py:
//   moai_ntt_fwd  <- _fwd_kernel (pallas_ntt.py:282), reached via ntt_pallas
//   moai_ntt_inv  <- _inv_kernel (pallas_ntt.py:301), reached via intt_pallas
// Contract (that of moai_tpu.ntt.ntt/intt): each row of N residues is in
// Montgomery form (x*2^32 mod q, q < 2^30), held in an int64 lane; the
// forward output index k holds the evaluation at root exponent 2k+1 of the
// limb's psi (natural order); the Montgomery factor is preserved; the
// inverse includes 1/N.  Every output is the canonical residue, so the
// result is bit-identical to any other exact NTT with the same psi.
//
// Bound: memory.  Each residue is read once (8 bytes) and written once
// (8 bytes), and the log2(N) butterfly stages run in shared memory, so
// device memory sees nothing else.  The integer work is of the same order
// on this card: at N=2^15, 15 stages of ~10 32-bit instructions per
// element each, against 16 bytes per element at 3.35 TB/s.  So the next
// steps (several stages per __syncthreads in registers, twiddles in shared
// memory) cut instructions and barriers, not bytes.
//
// Design (a simple right design, not yet a fast one):
// - One block per (row, limb): the row's N words sit in dynamic shared
//   memory as uint32 (N=2^15 is 128 KB, so one block per SM; N=2^16 would
//   need 256 KB, more than a block may have, and the wrapper refuses it).
// - Radix-2 butterflies, one __syncthreads per stage.  The forward is
//   Cooley-Tukey on natural input with psi merged into the twiddles
//   (table w[k] = psi^bitrev(k)); its bit-reversed result is written out in
//   natural order.  The inverse reads its input into bit-reversed positions
//   and runs Gentleman-Sande with w[k] = psi^-bitrev(k), then scales by 1/N.
// - Twiddles are plain residues with Shoup companions (__umulhi): a plain
//   multiplier keeps the data's Montgomery factor.  q < 2^30 keeps sums of
//   two residues below 2^31.  The TPU kernel's int8-digit matrix form and
//   its 16-bit-halves multiplies emulate a widening multiply that Hopper has
//   natively, so none of that is carried over.
// - Tables are per limb, [limbs, N] uint32, built once per context on the
//   card; the caller passes pointers already offset to the first active limb.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// x * w mod q for a precomputed w < q with ws = floor(w * 2^32 / q).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t w, uint32_t ws,
                                              uint32_t q) {
  uint32_t h = __umulhi(x, ws);
  uint32_t r = x * w - h * q;  // wraps; the exact value lies in [0, 2q)
  return r >= q ? r - q : r;
}

__global__ void ntt_fwd_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ y,
                               int limbs, int log_n, const uint32_t* __restrict__ q_tab,
                               const uint32_t* __restrict__ w_tab,
                               const uint32_t* __restrict__ ws_tab) {
  extern __shared__ uint32_t a[];
  const int n = 1 << log_n;
  const int half = n >> 1;
  const size_t row = blockIdx.x;
  const int limb = (int)(row % (size_t)limbs);
  const uint32_t q = q_tab[limb];
  const uint32_t* w = w_tab + (size_t)limb * n;
  const uint32_t* ws = ws_tab + (size_t)limb * n;
  const int64_t* xr = x + row * n;
  int64_t* yr = y + row * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = (uint32_t)xr[i];
  __syncthreads();

  // stage with m blocks of 2t: butterfly k -> block i = k / t, offset j
  for (int m = 1, log_t = log_n - 1; m < n; m <<= 1, --log_t) {
    const int t = 1 << log_t;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> log_t;
      const int j1 = (i << (log_t + 1)) + (k & (t - 1));
      const uint32_t u = a[j1];
      const uint32_t v = shoup_mul(a[j1 + t], w[m + i], ws[m + i], q);
      a[j1] = add_mod(u, v, q);
      a[j1 + t] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
  // bit-reversed -> natural order (index k <-> exponent 2k+1)
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    yr[k] = (int64_t)a[__brev((unsigned)k) >> (32 - log_n)];
}

__global__ void ntt_inv_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ y,
                               int limbs, int log_n, const uint32_t* __restrict__ q_tab,
                               const uint32_t* __restrict__ w_tab,
                               const uint32_t* __restrict__ ws_tab,
                               const uint32_t* __restrict__ ninv_tab,
                               const uint32_t* __restrict__ ninv_sh_tab) {
  extern __shared__ uint32_t a[];
  const int n = 1 << log_n;
  const int half = n >> 1;
  const size_t row = blockIdx.x;
  const int limb = (int)(row % (size_t)limbs);
  const uint32_t q = q_tab[limb];
  const uint32_t* w = w_tab + (size_t)limb * n;
  const uint32_t* ws = ws_tab + (size_t)limb * n;
  const int64_t* xr = x + row * n;
  int64_t* yr = y + row * n;

  // natural -> bit-reversed order
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    a[__brev((unsigned)k) >> (32 - log_n)] = (uint32_t)xr[k];
  __syncthreads();

  for (int h = half, log_t = 0; h >= 1; h >>= 1, ++log_t) {
    const int t = 1 << log_t;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> log_t;
      const int j1 = (i << (log_t + 1)) + (k & (t - 1));
      const uint32_t u = a[j1];
      const uint32_t v = a[j1 + t];
      a[j1] = add_mod(u, v, q);
      a[j1 + t] = shoup_mul(sub_mod(u, v, q), w[h + i], ws[h + i], q);
    }
    __syncthreads();
  }
  const uint32_t ninv = ninv_tab[limb], ninv_sh = ninv_sh_tab[limb];
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    yr[k] = (int64_t)shoup_mul(a[k], ninv, ninv_sh, q);
}

int launch_config(const void* kernel, int log_n, int* threads, size_t* smem) {
  const int n = 1 << log_n;
  *threads = n / 2 < 1024 ? n / 2 : 1024;
  *smem = (size_t)n * sizeof(uint32_t);
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*smem);
}

}  // namespace

// x, y: [rows, n] int64, row r holds limb r % limbs.  Tables are offset to
// the first active limb.  Returns the CUDA error code of the launch.
extern "C" int moai_ntt_fwd(const int64_t* x, int64_t* y, long long rows, int limbs,
                            int log_n, const uint32_t* q, const uint32_t* w,
                            const uint32_t* ws, void* stream) {
  int threads;
  size_t smem;
  int err = launch_config((const void*)ntt_fwd_kernel, log_n, &threads, &smem);
  if (err) return err;
  ntt_fwd_kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
      x, y, limbs, log_n, q, w, ws);
  return (int)cudaGetLastError();
}

extern "C" int moai_ntt_inv(const int64_t* x, int64_t* y, long long rows, int limbs,
                            int log_n, const uint32_t* q, const uint32_t* w,
                            const uint32_t* ws, const uint32_t* ninv,
                            const uint32_t* ninv_sh, void* stream) {
  int threads;
  size_t smem;
  int err = launch_config((const void*)ntt_inv_kernel, log_n, &threads, &smem);
  if (err) return err;
  ntt_inv_kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
      x, y, limbs, log_n, q, w, ws, ninv, ninv_sh);
  return (int)cudaGetLastError();
}
