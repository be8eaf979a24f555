// Kernels B3 (planned-fields commit) and B6 (lazy v1 greedy walk).
//
// B3 replaces the TPU kernel
// tamp_tpu/ops/encode_commit_pallas.py::_kernel_fields (via
// _commit_fields_batch, dual mode).  Per shard, a serial walk from
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

// Kernel B6: the lazy v1 greedy walk.
//
// Replaces the TPU kernel tamp_tpu/ops/encode_commit_pallas.py::_kernel
// (via encode_commit_batch, lazy=True).  Per shard, the reference greedy
// token walk over packed per-position tables, P[t] = len << 23 | idx << 8 |
// byte and Q[t] = plen << 15 | pidx (the cap-15 probe):
//   - a cached deferred match, when set, replaces (len, idx) and is cleared;
//   - the probe applies to every size, the cached one included (deferrals
//     chain): a match of minp..8 bytes is deferred to a literal when the
//     probe is strictly longer and its source [pidx, pidx + plen) does not
//     hold the write head tau = t & (W - 1); the probe is then cached;
//   - a match emits huffman(len - minp) then the index, a literal flag|byte;
//     bits drain MSB-first into bytes;
//   - a literal byte >= the literal limit sets ERR_EXCESS and t = npos.
// The walk stops at the first position >= npos - 15 and leaves its < 8-bit
// remainder and its lazy cache in the state row: [S_T, S_NBYTES, S_ACC,
// S_AN, S_CIDX, S_CSZ, S_ERR, 0...]; the host finishes the last < 16 bytes.
//
// What bounds it on this card: the dependence chain of the walk, as for
// B3: one thread walks a shard, each step a few shared-memory latencies.
//
// Design: B3's shape.  One block per shard; warps 1..7 double-buffer the
// next tile of P and Q in shared memory while thread 0 walks the current
// one and writes bytes straight to the output row.  The TPU kernel's SMEM
// output chunks and their DMA flushes are not carried over.

__constant__ uint8_t kHuffCode[14] = {0x00, 0x03, 0x08, 0x0B, 0x14,
                                      0x24, 0x26, 0x2B, 0x4B, 0x54,
                                      0x94, 0x95, 0xAA, 0x27};
__constant__ uint8_t kHuffLen[14] = {2, 3, 5, 5, 6, 7, 7, 7, 8, 8, 9, 9, 9, 7};

__global__ void __launch_bounds__(THREADS)
commit_v1_lazy_kernel(const int32_t* __restrict__ P,
                      const int32_t* __restrict__ Q,
                      const int32_t* __restrict__ npos_arr,
                      uint8_t* __restrict__ out, int32_t* __restrict__ state,
                      int NP, int max_out, int window, int literal,
                      int minp) {
  __shared__ int32_t sp[2][TILE];
  __shared__ int32_t sq[2][TILE];
  const int s = blockIdx.x;
  const int npos = npos_arr[s];
  const int hard_stop = npos - 15;  // first tail position (rem < 16)
  const int32_t* p_row = P + (size_t)s * NP;
  const int32_t* q_row = Q + (size_t)s * NP;
  uint8_t* o_row = out + (size_t)s * max_out;
  const int n_tiles = hard_stop > 0 ? (hard_stop + TILE - 1) / TILE : 0;
  const int wmask = (1 << window) - 1;
  const uint32_t lit_flag = 1u << literal;
  const int lit_limit = literal == 8 ? 256 : (1 << literal);

  // walker state (meaningful in thread 0 only)
  int t = 0, err = 0, an = 0, cidx = -1, csz = 0, nbytes = 0;
  uint32_t acc = 0;

  if (n_tiles > 0) {
    for (int i = threadIdx.x; i < TILE && i < NP; i += THREADS) {
      sp[0][i] = p_row[i];
      sq[0][i] = q_row[i];
    }
  }
  __syncthreads();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile & 1;
    if (threadIdx.x >= 32 && tile + 1 < n_tiles) {
      const int base = (tile + 1) * TILE;
      for (int i = threadIdx.x - 32; i < TILE && base + i < NP;
           i += THREADS - 32) {
        sp[cur ^ 1][i] = p_row[base + i];
        sq[cur ^ 1][i] = q_row[base + i];
      }
    }
    if (threadIdx.x == 0) {
      const int base = tile * TILE;
      const int end = min(base + TILE, hard_stop);
      while (t < end) {
        const int32_t p = sp[cur][t - base];
        const int32_t q = sq[cur][t - base];
        const int byte = p & 0xFF;
        int idx = (p >> 8) & 0x7FFF;
        int size = p >> 23;
        if (cidx >= 0) {
          idx = cidx;
          size = csz;
        }
        cidx = -1;
        const int pix = q & 0x7FFF;
        const int psz = q >> 15;
        const int tau = t & wmask;
        const bool go_lazy = size >= minp && size <= 8 && psz > size &&
                             !(pix <= tau && tau < pix + psz);
        if (go_lazy) {
          cidx = pix;
          csz = psz;
        }
        const bool is_match = size >= minp && !go_lazy;
        uint32_t v;
        int nb;
        if (is_match) {
          const int sym = min(size - minp, 13);
          v = ((uint32_t)kHuffCode[sym] << window) | (uint32_t)idx;
          nb = kHuffLen[sym] + window;
        } else {
          v = lit_flag | (uint32_t)byte;
          nb = literal + 1;
          if (byte >= lit_limit) err = ERR_EXCESS;
        }
        acc = (acc << nb) | v;  // an < 8 and nb <= 24: fits in 32 bits
        an += nb;
        while (an >= 8) {
          an -= 8;
          if (nbytes < max_out) o_row[nbytes] = (uint8_t)(acc >> an);
          ++nbytes;
          acc &= (1u << an) - 1;
        }
        t = is_match ? t + size : t + 1;
        if (err) {
          t = npos;
          break;
        }
      }
    }
    // barrier (the next tile is staged) and the walker's verdict in one
    if (__syncthreads_or(threadIdx.x == 0 && (err != 0 || t >= hard_stop)))
      break;
  }
  if (threadIdx.x == 0) {
    int32_t* st = state + (size_t)s * NSLOTS;
    st[0] = t;
    st[1] = nbytes;
    st[2] = (int32_t)acc;
    st[3] = an;
    st[4] = cidx;
    st[5] = csz;
    st[6] = err;
    for (int k = 7; k < NSLOTS; ++k) st[k] = 0;
  }
}

}  // namespace

extern "C" int tpt_commit_v1_lazy(const void* P, const void* Q,
                                  const void* npos, void* out, void* state,
                                  int S, int NP, int max_out, int window,
                                  int literal, int minp, void* stream) {
  commit_v1_lazy_kernel<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)P, (const int32_t*)Q, (const int32_t*)npos,
      (uint8_t*)out, (int32_t*)state, NP, max_out, window, literal, minp);
  return (int)cudaGetLastError();
}

extern "C" int tpt_commit_fields(const void* A, const void* B,
                                 const void* npos, void* out, void* state,
                                 int S, int NP, int max_out, int idx_bits,
                                 void* stream) {
  commit_fields_kernel<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)A, (const int32_t*)B, (const int32_t*)npos,
      (uint8_t*)out, (int32_t*)state, NP, max_out, idx_bits);
  return (int)cudaGetLastError();
}
