// Spark hash-partition ids of one int64 key column, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of auron_tpu/ops/pallas_kernels.py:
//   - _murmur3_pmod_kernel (partition_ids_pallas): Spark
//     Pmod(murmur3_x86_32(long, seed), n) per row,
// and folds in the caller's NULL blend (exec/shuffle/partitioning.py:49-65):
// a NULL key leaves Spark's running hash at the seed, so its id is
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

const char* auron_partition_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
