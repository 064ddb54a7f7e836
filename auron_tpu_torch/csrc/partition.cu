// Partition kernels of the shuffle and the planned exchange, for Hopper
// (sm_90a). They replace the Pallas kernels of auron_tpu/ops/pallas_kernels.py.
//
// K1, murmur3_pmod_kernel, replaces _murmur3_pmod_kernel
// (partition_ids_pallas): Spark Pmod(murmur3_x86_32(long, seed), n) per row,
// with the caller's NULL blend (exec/shuffle/partitioning.py:49-65) folded
// in: a NULL key leaves Spark's running hash at the seed, so its id is
// pmod(seed, n).
//
// Data: keys int64[n], validity uint8[n] (torch bool), out int32[n].
//
// Bound: memory traffic. Per row 8 + 1 bytes are read and 4 written; the
// hash is ~20 integer operations on registers. The TPU kernel padded the
// column to (rows, 128) tiles of uint32 lo/hi planes built by XLA before
// the call; here each thread reads its int64 straight from the key column
// (no split planes, no padding: the grid-stride loop masks the ragged
// edge) and writes its id once. No shared memory, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

// K2's per-block histogram budget: the 48 KB a block gets without opting in
// to more dynamic shared memory (12,288 counters).
#define AURON_HISTOGRAM_SHARED_BYTES (48u * 1024u)

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix(uint32_t h1, uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  k1 *= 0x1B873593u;
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ int pmod(int32_t s, int n) {
  int p = s % n;  // C truncates toward zero; Spark's Pmod floors
  return p < 0 ? p + n : p;
}

__global__ void murmur3_pmod_kernel(const long long* __restrict__ keys,
                                    const uint8_t* __restrict__ valid,
                                    int* __restrict__ out, long long n,
                                    int n_parts, uint32_t seed) {
  const int null_pid = pmod((int32_t)seed, n_parts);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned long long u = (unsigned long long)keys[i];
    uint32_t h = seed;
    h = mix(h, (uint32_t)u);
    h = mix(h, (uint32_t)(u >> 32));
    h ^= 8u;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    out[i] = valid[i] ? pmod((int32_t)h, n_parts) : null_pid;
  }
}

// K2, histogram_kernel, replaces _histogram_kernel
// (partition_histogram_pallas): rows per partition id, with the caller's
// liveness blend (parallel/mesh_driver.py:518, jnp.where(sel, pid, -1))
// done here: a row counts iff sel[i] and 0 <= pid[i] < n_parts.
//
// Data: pids int32[n], sel uint8[n] or null (every row live), out
// int32[n_parts], zeroed by the caller.
//
// Bound: memory traffic, the sel byte of every row and the 4 B id of every
// live row (a dead row's id is not needed, and not read). The TPU kernel
// compared the padded (rows, 128) id tile against an (n_parts, 1, 1) iota
// and summed the one-hot cube: n_parts x n work, shaped for the VPU. Here
// each row is read once. Each block keeps a private histogram in dynamic
// shared memory and adds its non-zero counters into `out` with one global
// atomic each at the end. Under skew (q93 sends ~89 % of its rows to one
// partition) every lane of a warp would hit the same shared counter, so the
// warp first groups its lanes by id (__match_any_sync) and one lane per
// group adds the group's size. Where n_parts counters do not fit the
// shared budget the same kernel adds straight into `out` (use_shared = 0).
// Integer atomics are exact and order-free: the result is bit-equal to a
// bincount on every run.
__global__ void histogram_kernel(const int* __restrict__ pids, const uint8_t* __restrict__ sel,
                                 int* __restrict__ out, long long n, int n_parts,
                                 int use_shared) {
  extern __shared__ int hist[];
  int* counts = use_shared ? hist : out;
  if (use_shared) {
    for (int p = threadIdx.x; p < n_parts; p += blockDim.x) hist[p] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is warp-uniform, so every lane takes part in the match
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < n;
       base += stride) {
    const long long i = base + lane;
    int key = -1;
    // a dead row's id is never read: warps over the dead tail load no ids
    if (i < n && (sel == nullptr || sel[i])) {
      const int p = pids[i];
      if ((unsigned)p < (unsigned)n_parts) key = p;
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(&counts[key], __popc(peers));
  }
  if (use_shared) {
    __syncthreads();
    for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
      if (hist[p]) atomicAdd(&out[p], hist[p]);
    }
  }
}

}  // namespace

extern "C" {

// K1: out[i] = valid[i] ? pmod(murmur3(keys[i], seed), n_parts) : pmod(seed, n_parts).
int auron_murmur3_pmod(const void* keys, const void* valid, void* out, long long n,
                       int n_parts, unsigned seed, void* stream) {
  if (n < 0 || n_parts < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident blocks per SM
  murmur3_pmod_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (const uint8_t*)valid, (int*)out, n, n_parts, (uint32_t)seed);
  return (int)cudaGetLastError();
}

// K2: out[p] += rows i with (sel == null || sel[i]) and pids[i] == p, for
// 0 <= p < n_parts. `out` must hold zeros.
int auron_partition_histogram(const void* pids, const void* sel, void* out, long long n,
                              int n_parts, void* stream) {
  if (n < 0 || n_parts < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  const size_t shared = (size_t)n_parts * sizeof(int);
  const int use_shared = shared <= AURON_HISTOGRAM_SHARED_BYTES;
  // at least 16 rows per counter in each block, so the per-block flush of
  // up to n_parts atomics stays small beside the rows it summarises
  const long long per_block = n_parts * 16LL > threads ? n_parts * 16LL : threads;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 132 * 8) blocks = 132 * 8;
  histogram_kernel<<<(unsigned)blocks, threads, use_shared ? shared : 0,
                     (cudaStream_t)stream>>>((const int*)pids, (const uint8_t*)sel, (int*)out, n,
                                             n_parts, use_shared);
  return (int)cudaGetLastError();
}

// The largest n_parts whose counters fit the shared-memory branch.
int auron_partition_histogram_shared_parts(void) {
  return (int)(AURON_HISTOGRAM_SHARED_BYTES / sizeof(int));
}

const char* auron_partition_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
