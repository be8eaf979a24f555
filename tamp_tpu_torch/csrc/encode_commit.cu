// Kernel B3: planned-fields commit of the extended encode.
//
// Replaces the TPU kernel tamp_tpu/ops/encode_commit_pallas.py::_kernel_fields
// (via _commit_fields_batch, dual mode).  Per shard, a serial walk from
// model position 0: at position t read the planned field A[t] (value) and
// B[t] (nb | adv << 6 | err << 14 | split flag << 15 | index << 16), push
// nb bits of the value into a 64-bit accumulator, drain each completed
// 32-bit word MSB-first (its bytes go out big-endian), push the split index
// second when the flag is set and idx_bits > 0 (window >= 14), and jump to
// t + adv.  An error field sets ERR_EXCESS and ends the walk with t = npos
// (so does a zero advance, with ERR_STALL: the planner never makes one, and
// the walk must not spin on malformed input).  The walk stops at the first token start t >= npos - 15; the host finishes
// the last < 16 model bytes.  State row per shard (int32 x 16):
// [S_T, S_NBYTES, S_ACC, S_AN, S_CIDX = -1, S_CSZ = 0, S_ERR, 0...].
//
// What bounds it on this card: the dependence chain of the walk (each step
// needs the previous step's advance), not bytes: one thread walks a shard,
// so the kernel uses S SMs and each step costs a few shared-memory
// latencies.
//
// Design: one block per shard.  Warp 0's lane 0 walks; warps 1..7 stage the
// next tile of A and B into the other half of a double buffer in shared
// memory while the walker consumes the current one, so the walker never
// waits on device memory.  The walker writes bytes straight to the output
// row.  The TPU kernel's SMEM chunk flushes and hi:lo int32 accumulator
// answer the TPU scalar core's constraints and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;  // positions per staged tile
constexpr int ERR_EXCESS = 1;
constexpr int ERR_STALL = 2;  // a zero advance: malformed fields, not data
constexpr int NSLOTS = 16;

__global__ void __launch_bounds__(THREADS)
commit_fields_kernel(const int32_t* __restrict__ A,
                     const int32_t* __restrict__ B,
                     const int32_t* __restrict__ npos_arr,
                     uint8_t* __restrict__ out, int32_t* __restrict__ state,
                     int NP, int max_out, int idx_bits) {
  __shared__ int32_t sa[2][TILE];
  __shared__ int32_t sb[2][TILE];
  const int s = blockIdx.x;
  const int npos = npos_arr[s];
  const int hard_stop = npos - 15;  // first tail position (rem < 16)
  const int32_t* a_row = A + (size_t)s * NP;
  const int32_t* b_row = B + (size_t)s * NP;
  uint8_t* o_row = out + (size_t)s * max_out;
  const int n_tiles = hard_stop > 0 ? (hard_stop + TILE - 1) / TILE : 0;

  // walker state (meaningful in thread 0 only)
  int t = 0, err = 0, an = 0;
  int64_t nbytes = 0;
  uint64_t acc = 0;

  if (n_tiles > 0) {
    for (int i = threadIdx.x; i < TILE && i < NP; i += THREADS) {
      sa[0][i] = a_row[i];
      sb[0][i] = b_row[i];
    }
  }
  __syncthreads();
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
        const int32_t v = sa[cur][t - base];
        const int32_t m = sb[cur][t - base];
        const int nb = m & 63;
        acc = (acc << nb) | (uint32_t)v;
        an += nb;
        if (an >= 32) {
          const uint32_t w = (uint32_t)(acc >> (an - 32));
          if (nbytes + 4 <= max_out) {
            o_row[nbytes] = (uint8_t)(w >> 24);
            o_row[nbytes + 1] = (uint8_t)(w >> 16);
            o_row[nbytes + 2] = (uint8_t)(w >> 8);
            o_row[nbytes + 3] = (uint8_t)w;
          }
          nbytes += 4;
          an -= 32;
        }
        if (idx_bits > 0 && ((m >> 15) & 1)) {
          acc = (acc << idx_bits) | (uint32_t)((m >> 16) & 0x7FFF);
          an += idx_bits;
          if (an >= 32) {
            const uint32_t w = (uint32_t)(acc >> (an - 32));
            if (nbytes + 4 <= max_out) {
              o_row[nbytes] = (uint8_t)(w >> 24);
              o_row[nbytes + 1] = (uint8_t)(w >> 16);
              o_row[nbytes + 2] = (uint8_t)(w >> 8);
              o_row[nbytes + 3] = (uint8_t)w;
            }
            nbytes += 4;
            an -= 32;
          }
        }
        const int adv = (m >> 6) & 255;
        if ((m & (1 << 14)) || adv == 0) {
          err = (m & (1 << 14)) ? ERR_EXCESS : ERR_STALL;
          t = npos;
          break;
        }
        t += adv;
      }
    }
    // barrier (the next tile is staged) and the walker's verdict in one
    if (__syncthreads_or(threadIdx.x == 0 && (err != 0 || t >= hard_stop)))
      break;
  }
  if (threadIdx.x == 0) {
    int32_t* st = state + (size_t)s * NSLOTS;
    st[0] = t;
    st[1] = (int32_t)nbytes;
    st[2] = (int32_t)((uint32_t)acc & (uint32_t)((1ull << an) - 1));
    st[3] = an;
    st[4] = -1;
    st[5] = 0;
    st[6] = err;
    for (int k = 7; k < NSLOTS; ++k) st[k] = 0;
  }
}

}  // namespace

extern "C" int tpt_commit_fields(const void* A, const void* B,
                                 const void* npos, void* out, void* state,
                                 int S, int NP, int max_out, int idx_bits,
                                 void* stream) {
  commit_fields_kernel<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)A, (const int32_t*)B, (const int32_t*)npos,
      (uint8_t*)out, (int32_t*)state, NP, max_out, idx_bits);
  return (int)cudaGetLastError();
}
