// Bitonic sort network over stacked uint32 key planes, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of auron_tpu/ops/bitonic.py:
//   - _bitonic_kernel (_run_pallas): the full network over one on-chip block,
//     here `bitonic_local` in tile-sort mode (auron_bitonic_block_sort);
//   - _merge_kernel (_run_pallas_merge / _merge_pairs / _tiled_sort): the
//     merge stage that lifts the sort past one block, here one bitonic stage
//     k as `bitonic_global` steps for strides j >= T plus `bitonic_local` in
//     tail mode for j < T (auron_bitonic_merge_stage).
//
// Data: NP planes of P uint32 each, plane-major ([NP][P], stride P), the
// last plane a distinct int32 payload, so the lexicographic order across
// planes is total and the result equals a stable multi-key sort. P is a
// power of two. Planes are sorted in place.
//
// Bound: memory traffic. Every global step reads and writes NP*P*4 bytes;
// the arithmetic is a few integer compares per element per step. The
// design cuts global passes: one CTA keeps a tile of T elements x NP planes
// in dynamic shared memory and runs every substage with stride j < T there,
// so each stage k pays log2(k/T) global passes instead of log2(k), and the
// initial tile sort (all k <= T) pays none. Nothing is tuned yet (no
// register-resident substages, no vectorized loads): a simple kernel that
// is right comes first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -1 / 0 / +1: lexicographic compare of elements ia and ib across np planes.
__device__ __forceinline__ int lex_cmp(const unsigned* base, long long stride,
                                       long long ia, long long ib, int np) {
  for (int p = 0; p < np; ++p) {
    unsigned a = base[p * stride + ia];
    unsigned b = base[p * stride + ib];
    if (a != b) return a < b ? -1 : 1;
  }
  return 0;
}

__device__ __forceinline__ void swap_planes(unsigned* base, long long stride,
                                            long long ia, long long ib, int np) {
  for (int p = 0; p < np; ++p) {
    unsigned t = base[p * stride + ia];
    base[p * stride + ia] = base[p * stride + ib];
    base[p * stride + ib] = t;
  }
}

// Position of the t-th pair's lower element for stride j: insert a 0 bit at j.
__device__ __forceinline__ long long pair_lo(long long t, long long j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// Compare-exchange of (i, i|j): ascending where bit k of the GLOBAL index is
// clear, descending where it is set (want_max = bit_j != bit_k in the Pallas
// network's _substage).
__device__ __forceinline__ void cmp_exchange(unsigned* base, long long stride,
                                             long long i, long long l,
                                             bool desc, int np) {
  int c = lex_cmp(base, stride, i, l, np);
  if (desc ? (c < 0) : (c > 0)) swap_planes(base, stride, i, l, np);
}

// One CTA per tile of T elements. k_fixed == 0: tile sort, every stage
// k = 2..T with all its substages. k_fixed > 0: the tail of stage k_fixed,
// substages j = T/2..1.
__global__ void bitonic_local(unsigned* __restrict__ x, int np, long long P,
                              int T, long long k_fixed) {
  extern __shared__ unsigned s[];
  const long long base = (long long)blockIdx.x * T;
  for (int p = 0; p < np; ++p)
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      s[p * T + i] = x[p * P + base + i];
  __syncthreads();
  const int half = T >> 1;
  const long long k_lo = k_fixed ? k_fixed : 2;
  const long long k_hi = k_fixed ? k_fixed : T;
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    const int j0 = k_fixed ? half : (int)(k >> 1);
    for (int j = j0; j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const long long i = pair_lo(t, j);
        cmp_exchange(s, T, i, i | j, ((base + i) & k) != 0, np);
      }
      __syncthreads();
    }
  }
  for (int p = 0; p < np; ++p)
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      x[p * P + base + i] = s[p * T + i];
}

// One substage of stage k with a stride j >= T: one thread per pair.
__global__ void bitonic_global(unsigned* __restrict__ x, int np, long long P,
                               long long k, long long j) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (P >> 1)) return;
  const long long i = pair_lo(t, j);
  cmp_exchange(x, P, i, i | j, (i & k) != 0, np);
}

int launch_local(unsigned* x, int np, long long P, int T, long long k_fixed,
                 cudaStream_t stream) {
  const size_t smem = (size_t)np * T * sizeof(unsigned);
  cudaError_t e = cudaFuncSetAttribute(
      bitonic_local, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (T / 2) < 1024 ? (T / 2) : 1024;
  bitonic_local<<<(unsigned)(P / T), threads, smem, stream>>>(x, np, P, T, k_fixed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: sort every tile of T elements (alternating direction by tile, i.e.
// the first log2(T) stages of the global network). For P == T this is the
// whole sort.
int auron_bitonic_block_sort(void* x, int np, long long P, int T, void* stream) {
  if (T < 2 || P % T != 0) return (int)cudaErrorInvalidValue;
  return launch_local((unsigned*)x, np, P, T, 0, (cudaStream_t)stream);
}

// K4: stage k of the network (k >= T, power of two): global substages for
// j = k/2 .. T, then the shared-memory tail j < T. With k == P it is the
// merge of one bitonic sequence into ascending order.
int auron_bitonic_merge_stage(void* x, int np, long long P, int T, long long k,
                              void* stream) {
  if (T < 2 || P % T != 0 || k < T || k > P) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long pairs = P >> 1;
  const int threads = 256;
  const unsigned blocks = (unsigned)((pairs + threads - 1) / threads);
  for (long long j = k >> 1; j >= T; j >>= 1) {
    bitonic_global<<<blocks, threads, 0, s>>>((unsigned*)x, np, P, k, j);
    int e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  return launch_local((unsigned*)x, np, P, T, k, s);
}

const char* auron_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
