// Chain-floor probes for the serial walks of kernels B4 and B3 (a
// measurement tool, not a kernel of any path; tools/torch_walk_probe.py
// builds and times it).
//
// Each probe walks the same chain as its kernel, in the first port's
// skeleton (one block per shard, thread 0 walks a shared-memory tile while
// warps 1..7 stage the next one, one barrier per tile), and does nothing
// else: no ring, no output, no bit packing.  Its time is what the chain
// alone costs in that skeleton, so a kernel's time minus its probe's is
// what the kernel spends on top of its chain.
//   - probe_decode_chain: c += delta over the fused parse words (B4's chain),
//     folding kind, cnt and idx into a checksum so they stay decoded;
//   - probe_fields_chain: t += adv over the planned fields (B3's chain) up to
//     the first t >= npos - 15 or an error field, folding A into a checksum.
// Outputs per shard: steps and checksum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;

__global__ void __launch_bounds__(THREADS)
probe_decode_chain(const int32_t* __restrict__ pk, int32_t* __restrict__ res,
                   int NBP) {
  __shared__ int32_t tiles[2][TILE];
  const int s = blockIdx.x;
  const int32_t* row = pk + (size_t)s * NBP;
  const int n_tiles = (NBP + TILE - 1) / TILE;
  for (int i = threadIdx.x; i < TILE && i < NBP; i += THREADS)
    tiles[0][i] = row[i];
  __syncthreads();
  int c = 0, n = 0;
  uint32_t sum = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * TILE;
      for (int i = threadIdx.x - 32; i < TILE && base + i < NBP;
           i += THREADS - 32)
        tiles[cur ^ 1][i] = row[base + i];
    }
    if (threadIdx.x == 0) {
      const int base = tile * TILE;
      const int end = min(base + TILE, NBP);
      while (c < end) {
        const int32_t p = tiles[cur][c - base];
        const int delta = (p >> 11) & 63;
        if (delta == 0) {
          c = NBP;
          break;
        }
        sum = sum * 31u + (uint32_t)((p & 0x7FF) ^ (p >> 17));
        ++n;
        c += delta;
      }
    }
    if (__syncthreads_or(threadIdx.x == 0 && c >= NBP)) break;
  }
  if (threadIdx.x == 0) {
    res[2 * s] = n;
    res[2 * s + 1] = (int32_t)sum;
  }
}

__global__ void __launch_bounds__(THREADS)
probe_fields_chain(const int32_t* __restrict__ A, const int32_t* __restrict__ B,
                   const int32_t* __restrict__ npos_arr,
                   int32_t* __restrict__ res, int NP) {
  __shared__ int32_t sa[2][TILE];
  __shared__ int32_t sb[2][TILE];
  const int s = blockIdx.x;
  const int hard_stop = npos_arr[s] - 15;
  const int32_t* a_row = A + (size_t)s * NP;
  const int32_t* b_row = B + (size_t)s * NP;
  const int n_tiles = hard_stop > 0 ? (hard_stop + TILE - 1) / TILE : 0;
  if (n_tiles > 0) {
    for (int i = threadIdx.x; i < TILE && i < NP; i += THREADS) {
      sa[0][i] = a_row[i];
      sb[0][i] = b_row[i];
    }
  }
  __syncthreads();
  int t = 0, n = 0, stop = 0;
  uint32_t sum = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * TILE;
      for (int i = threadIdx.x - 32; i < TILE && base + i < NP;
           i += THREADS - 32) {
        sa[cur ^ 1][i] = a_row[base + i];
        sb[cur ^ 1][i] = b_row[base + i];
      }
    }
    if (threadIdx.x == 0) {
      const int base = tile * TILE;
      const int end = min(base + TILE, hard_stop);
      while (t < end) {
        const int32_t m = sb[cur][t - base];
        sum = sum * 31u + (uint32_t)sa[cur][t - base];
        ++n;
        const int adv = (m >> 6) & 255;
        if ((m & (1 << 14)) || adv == 0) {
          stop = 1;
          break;
        }
        t += adv;
      }
    }
    if (__syncthreads_or(threadIdx.x == 0 && (stop || t >= hard_stop)))
      break;
  }
  if (threadIdx.x == 0) {
    res[2 * s] = n;
    res[2 * s + 1] = (int32_t)sum;
  }
}

}  // namespace

extern "C" int tpt_probe_decode_chain(const void* pk, void* res, int S,
                                      int NBP, void* stream) {
  probe_decode_chain<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pk, (int32_t*)res, NBP);
  return (int)cudaGetLastError();
}

extern "C" int tpt_probe_fields_chain(const void* A, const void* B,
                                      const void* npos, void* res, int S,
                                      int NP, void* stream) {
  probe_fields_chain<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)A, (const int32_t*)B, (const int32_t*)npos,
      (int32_t*)res, NP);
  return (int)cudaGetLastError();
}
