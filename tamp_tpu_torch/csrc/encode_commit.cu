// Kernels B3 (planned-fields commit) and B6 (lazy v1 greedy walk).
//
// B3 replaces the TPU kernel
// tamp_tpu/ops/encode_commit_pallas.py::_kernel_fields (via
// _commit_fields_batch, dual mode).  Per shard, a walk from model
// position 0: at position t read the planned field A[t] (value) and B[t]
// (nb | adv << 6 | err << 14 | split flag << 15 | index << 16), push nb bits
// of the value into a 64-bit accumulator, drain each completed 32-bit word
// MSB-first (its bytes go out big-endian, and only while the word fits in
// max_out; S_NBYTES counts on), push the split index second when the flag is
// set and idx_bits > 0 (window >= 14), and jump to t + adv.  An error field
// sets ERR_EXCESS and ends the walk with t = npos (so does a zero advance,
// with ERR_STALL: the planner never makes one, and the walk must not spin
// on malformed input); the error field's bits are pushed first.  The walk
// stops at the first token start t >= npos - 15; the host finishes the last
// < 16 model bytes.  State row per shard (int32 x 16):
// [S_T, S_NBYTES, S_ACC, S_AN, S_CIDX = -1, S_CSZ = 0, S_ERR, 0...].
//
// What bounds it on this card: as one walk a shard, the dependence chain
// t += adv (the first port ran it on one thread a shard, 8 of 132 SMs at
// about 72 ns a step).  But the chain depends on the advance field alone,
// so it resolves in parallel; what is left is bytes (each visited field
// read once, each output byte written once) and a few operations a
// position.
//
// Design: four launches on the caller's stream, over tiles of FT = 4096
// positions, every tile of every shard a block.
//   1. fields_maps_kernel: per tile, in shared memory, the exit map of every
//      position (the first chain position at or past the tile's end, or a
//      sink for an error field or a zero advance) with the bits pushed on
//      the way, by pointer doubling over next[i] = i + adv[i]: log2(FT)
//      rounds.  A tile is entered at one of its first 256 positions
//      (adv <= 255), so only those 256 maps are kept.
//   2. fields_entries_kernel: per shard, one lookup a tile composes the
//      maps into each visited tile's entry and bit offset, the stop and the
//      state row (all but S_ACC).
//   3. fields_pack_kernel: each visited tile walks its own chain from its
//      entry, in shared memory, with the accumulator started at its bit
//      offset, and ORs each completed word into a word row (atomicOr: the
//      words at tile seams are shared); the word holding the stream's last
//      partial bits also goes to a tail slot.
//   4. fields_finish_kernel: the complete words that fit in max_out to the
//      output row, and S_ACC from the tail slot.
// The maps, entries, offsets and word rows are a workspace the C entry
// allocates and frees on the stream (cudaMallocAsync from the device's
// default pool, which it sets to keep its memory), so its signature stays
// the first port's.  The TPU kernel's SMEM chunk flushes and hi:lo
// int32 accumulator answer the TPU scalar core's constraints and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // B6
constexpr int TILE = 2048;    // B6: positions per staged tile
constexpr int ERR_EXCESS = 1;
constexpr int ERR_STALL = 2;  // a zero advance: malformed fields, not data
constexpr int NSLOTS = 16;

constexpr int FT = 4096;            // B3: positions per tile
constexpr int FENT = 256;           // B3: entry offsets of a tile
constexpr int MAP_THREADS = 256;
constexpr int PACK_THREADS = 128;
constexpr int SINK_EXCESS = -1, SINK_STALL = -2;  // exit-map sinks

// a map word: bits pushed << 32 | exit position (or a sink)
__device__ __forceinline__ int map_exit(int64_t v) {
  return (int)(uint32_t)(uint64_t)v;
}

__global__ void __launch_bounds__(MAP_THREADS)
fields_maps_kernel(const int32_t* __restrict__ B,
                   const int32_t* __restrict__ npos_arr,
                   int64_t* __restrict__ maps, int NP, int n_tiles,
                   int idx_bits) {
  __shared__ int64_t F[FT];
  const int s = blockIdx.y, k = blockIdx.x, base = k * FT;
  const int limit = min(npos_arr[s] - 15, NP);  // first position not walked
  if (base >= limit) return;                    // never entered
  const int E = min(FT, limit - base);          // local positions walked
  const int32_t* b_row = B + (size_t)s * NP + base;
  for (int i = threadIdx.x; i < FT; i += MAP_THREADS) {
    int f = i;  // a position past the walk is its own exit
    int64_t bits = 0;
    if (i < E) {
      const int32_t m = b_row[i];
      const int adv = (m >> 6) & 255;
      bits = (m & 63) + ((idx_bits > 0 && ((m >> 15) & 1)) ? idx_bits : 0);
      f = (m & (1 << 14)) ? SINK_EXCESS : adv == 0 ? SINK_STALL : i + adv;
    }
    F[i] = (int64_t)((uint64_t)bits << 32 | (uint32_t)f);
  }
  __syncthreads();
  // pointer doubling; in place is safe: every value is a valid (exit, bits)
  // pair of its position, and a later one only lies further along
  for (int r = 1; r < FT; r <<= 1) {
    for (int i = threadIdx.x; i < FT; i += MAP_THREADS) {
      const int64_t v = F[i];
      const int g = map_exit(v);
      if (g >= 0 && g < E) {
        const int64_t w = F[g];
        F[i] = (int64_t)((uint64_t)((v >> 32) + (w >> 32)) << 32 |
                         (uint32_t)map_exit(w));
      }
    }
    __syncthreads();
  }
  int64_t* m_row = maps + ((size_t)s * n_tiles + k) * FENT;
  for (int o = threadIdx.x; o < FENT; o += MAP_THREADS) {
    const int64_t v = F[o];
    const int g = map_exit(v);
    m_row[o] = (int64_t)((uint64_t)(v >> 32) << 32 |
                         (uint32_t)(g < 0 ? g : base + g));
  }
}

__global__ void fields_entries_kernel(const int32_t* __restrict__ npos_arr,
                                      const int64_t* __restrict__ maps,
                                      int32_t* __restrict__ ent,
                                      int64_t* __restrict__ off,
                                      int64_t* __restrict__ total,
                                      int32_t* __restrict__ state, int NP,
                                      int n_tiles) {
  const int s = blockIdx.x;
  int32_t* e_row = ent + (size_t)s * n_tiles;
  for (int i = threadIdx.x; i < n_tiles; i += 32) e_row[i] = -1;
  __syncwarp();
  if (threadIdx.x != 0) return;
  const int npos = npos_arr[s];
  const int limit = min(npos - 15, NP);
  int e = 0;
  int64_t bits = 0;
  while (e >= 0 && e < limit) {  // e lies in the first FENT of its tile
    const int k = e / FT;
    e_row[k] = e;
    off[(size_t)s * n_tiles + k] = bits;
    const int64_t v = maps[((size_t)s * n_tiles + k) * FENT + (e - k * FT)];
    bits += v >> 32;
    e = map_exit(v);
  }
  const int err = e == SINK_EXCESS ? ERR_EXCESS
                  : e == SINK_STALL ? ERR_STALL
                                    : 0;
  total[s] = bits;
  int32_t* st = state + (size_t)s * NSLOTS;
  st[0] = err ? npos : e;
  st[1] = (int32_t)(4 * (bits >> 5));
  st[2] = 0;  // S_ACC: fields_finish_kernel
  st[3] = (int32_t)(bits & 31);
  st[4] = -1;
  st[5] = 0;
  st[6] = err;
  for (int k = 7; k < NSLOTS; ++k) st[k] = 0;
}

__global__ void __launch_bounds__(PACK_THREADS)
fields_pack_kernel(const int32_t* __restrict__ A,
                   const int32_t* __restrict__ B,
                   const int32_t* __restrict__ npos_arr,
                   const int32_t* __restrict__ ent,
                   const int64_t* __restrict__ off,
                   const int64_t* __restrict__ total,
                   uint32_t* __restrict__ words, int NP, int n_tiles, int nw,
                   int idx_bits) {
  __shared__ int32_t sa[FT];
  __shared__ int32_t sb[FT];
  const int s = blockIdx.y, k = blockIdx.x, base = k * FT;
  const int e = ent[(size_t)s * n_tiles + k];
  if (e < 0) return;
  const int end = min(base + FT, min(npos_arr[s] - 15, NP));
  const int32_t* a_row = A + (size_t)s * NP;
  const int32_t* b_row = B + (size_t)s * NP;
  for (int i = e + threadIdx.x; i < end; i += PACK_THREADS) {
    sa[i - base] = a_row[i];
    sb[i - base] = b_row[i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t* w_row = words + (size_t)s * (nw + 1);  // [nw] is the tail slot
  const int64_t wf = total[s] >> 5;  // the word of the last partial bits
  const int64_t p0 = off[(size_t)s * n_tiles + k];
  int64_t widx = p0 >> 5;
  int an = (int)(p0 & 31);  // the bits before the tile's first: zeros here
  uint64_t acc = 0;
  auto put = [&](uint32_t w) {  // the word widx, big-endian in memory
    if (widx < nw) atomicOr(&w_row[widx], __byte_perm(w, 0, 0x0123));
    if (widx == wf) atomicOr(&w_row[nw], w);
    ++widx;
  };
  for (int t = e; t < end;) {
    const int32_t m = sb[t - base];
    const int nb = m & 63;
    acc = (acc << nb) | (uint32_t)sa[t - base];
    an += nb;
    if (an >= 32) {
      put((uint32_t)(acc >> (an - 32)));
      an -= 32;
    }
    if (idx_bits > 0 && ((m >> 15) & 1)) {
      acc = (acc << idx_bits) | (uint32_t)((m >> 16) & 0x7FFF);
      an += idx_bits;
      if (an >= 32) {
        put((uint32_t)(acc >> (an - 32)));
        an -= 32;
      }
    }
    const int adv = (m >> 6) & 255;
    if ((m & (1 << 14)) || adv == 0) break;
    t += adv;
  }
  if (an > 0) put((uint32_t)(acc << (32 - an)));  // the seam or last word
}

__global__ void fields_finish_kernel(const uint32_t* __restrict__ words,
                                     const int64_t* __restrict__ total,
                                     uint8_t* __restrict__ out,
                                     int32_t* __restrict__ state, int max_out,
                                     int nw) {
  const int s = blockIdx.y;
  const uint32_t* w_row = words + (size_t)s * (nw + 1);
  const int64_t bits = total[s];
  const int64_t n = min(bits >> 5, (int64_t)nw);  // complete words that fit
  uint8_t* o_row = out + (size_t)s * max_out;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((max_out & 3) == 0 && ((uintptr_t)o_row & 3) == 0) {
    for (int64_t i = i0; i < n; i += step)
      reinterpret_cast<uint32_t*>(o_row)[i] = w_row[i];
  } else {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(w_row);
    for (int64_t i = i0; i < 4 * n; i += step) o_row[i] = src[i];
  }
  if (i0 == 0) {
    const int an = (int)(bits & 31);
    state[(size_t)s * NSLOTS + 2] =
        an ? (int32_t)(w_row[nw] >> (32 - an)) : 0;
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
// What bounds it on this card: the dependence chain of the walk: one
// thread walks a shard, each step a few shared-memory latencies.  Unlike
// B3's, the chain carries the lazy cache, so it does not resolve from the
// advance alone.
//
// Design: one block per shard; warps 1..7 double-buffer the next tile of P
// and Q in shared memory while thread 0 walks the current one and writes
// bytes straight to the output row.  The TPU kernel's SMEM output chunks
// and their DMA flushes are not carried over.

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
  if (S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (NP + FT - 1) / FT;
  const int nw = max_out / 4;  // words that fit in max_out
  const size_t n_maps = (size_t)S * n_tiles * FENT;
  const size_t n_off = (size_t)S * n_tiles;
  const size_t n_words = (size_t)S * (nw + 1);
  const size_t bytes = 8 * (n_maps + n_off + S) + 4 * (n_off + n_words);
  // the default pool keeps what it has held (its threshold is 0 by
  // default, so every synchronize would return the workspace to the driver
  // and the next call would pay to map it again)
  int dev = 0;
  cudaMemPool_t pool;
  uint64_t keep = UINT64_MAX;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetDefaultMemPool(&pool, dev);
  if (e == cudaSuccess)
    e = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
  if (e != cudaSuccess) return (int)e;
  char* ws = nullptr;
  e = cudaMallocAsync((void**)&ws, bytes, st);
  if (e != cudaSuccess) return (int)e;
  int64_t* maps = reinterpret_cast<int64_t*>(ws);
  int64_t* off = maps + n_maps;
  int64_t* total = off + n_off;
  int32_t* ent = reinterpret_cast<int32_t*>(total + S);
  uint32_t* words = reinterpret_cast<uint32_t*>(ent + n_off);
  e = cudaMemsetAsync(words, 0, 4 * n_words, st);
  if (e == cudaSuccess) {
    if (n_tiles > 0)
      fields_maps_kernel<<<dim3(n_tiles, S), MAP_THREADS, 0, st>>>(
          (const int32_t*)B, (const int32_t*)npos, maps, NP, n_tiles,
          idx_bits);
    fields_entries_kernel<<<S, 32, 0, st>>>((const int32_t*)npos, maps, ent,
                                            off, total, (int32_t*)state, NP,
                                            n_tiles);
    if (n_tiles > 0)
      fields_pack_kernel<<<dim3(n_tiles, S), PACK_THREADS, 0, st>>>(
          (const int32_t*)A, (const int32_t*)B, (const int32_t*)npos, ent,
          off, total, words, NP, n_tiles, nw, idx_bits);
    const int blocks = max(1, min(64, (nw + 255) / 256));
    fields_finish_kernel<<<dim3(blocks, S), 256, 0, st>>>(
        words, total, (uint8_t*)out, (int32_t*)state, max_out, nw);
    e = cudaGetLastError();
  }
  const cudaError_t f = cudaFreeAsync(ws, st);
  return (int)(e != cudaSuccess ? e : f);
}
