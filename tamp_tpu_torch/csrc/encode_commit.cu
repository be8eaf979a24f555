// Kernels B3 (planned-fields commit) and B6 (lazy v1 greedy walk), both
// tile-parallel walks over per-tile exit maps.
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

constexpr int ERR_EXCESS = 1;
constexpr int ERR_STALL = 2;  // a zero advance: malformed fields, not data
constexpr int NSLOTS = 16;

constexpr int FT = 4096;            // positions per tile (B3 and B6)
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
//     bits drain MSB-first into bytes (a value wider than its field ORs its
//     high bits into the pending bits, as the reference's accumulator does);
//   - a literal byte >= the literal limit sets ERR_EXCESS and t = npos.
// The walk stops at the first position >= npos - 15 and leaves its < 8-bit
// remainder and its lazy cache in the state row: [S_T, S_NBYTES, S_ACC,
// S_AN, S_CIDX, S_CSZ, S_ERR, 0...]; S_CSZ keeps the last deferred size
// even after the cache is used.  The host finishes the last < 16 bytes.
//
// What bounds it on this card: as one walk a shard, its dependence chain
// (the first port ran it on one thread a shard, 8 of 132 SMs).  But the
// walk's state is finite: the cache at t is either empty or the probe of
// t - 1 (it is set only from Q[t - 1]).  So the walk is a function on the
// nodes (t, d), d = 1 when t is entered with a deferred match, and resolves
// in parallel as B3's does; what is left is bytes and a few operations a
// step.
//
// Design: B3's four launches on the caller's stream, over tiles of FT
// positions (2 x FT nodes), every tile of every shard a block:
//   1. lazy_maps_kernel: per tile, in shared memory, the exit map of every
//      node (the first chain node at or past the tile's end, or a sink that
//      names the node whose literal is an excess byte) with the bits pushed
//      on the way, by pointer doubling: log2(FT) rounds.  A match's advance
//      can be a cached probe size up to 65535, so a tile can be entered at
//      any node and every node's map is kept (16 B a position).
//   2. lazy_entries_kernel: per shard, one lookup a visited tile gives each
//      visited tile's entry node and bit offset, the stop (or the erring
//      node) and the state row (all but S_ACC, S_CIDX and S_CSZ).
//   3. lazy_pack_kernel: each visited tile walks its own chain from its
//      entry node, in shared memory, with the accumulator started at its bit
//      offset, and ORs each completed word into a word row (atomicOr: the
//      words at tile seams are shared); the word holding the stream's last
//      partial bits also goes to a tail slot.  It leaves its cache at its
//      exit and the last deferred size it saw.
//   4. lazy_finish_kernel: the bytes that fit in max_out to the output row,
//      S_ACC from the tail slot, S_CIDX and S_CSZ from the tiles.
// The wrapper (ops/encode_commit.commit_v1_lazy) allocates the workspace
// with torch.  The TPU kernel's SMEM output chunks and their DMA flushes
// are not carried over.

__constant__ uint8_t kHuffCode[14] = {0x00, 0x03, 0x08, 0x0B, 0x14,
                                      0x24, 0x26, 0x2B, 0x4B, 0x54,
                                      0x94, 0x95, 0xAA, 0x27};
__constant__ uint8_t kHuffLen[14] = {2, 3, 5, 5, 6, 7, 7, 7, 8, 8, 9, 9, 9, 7};

constexpr int LAZY_MAP_THREADS = 512;
constexpr int LAZY_PACK_THREADS = 128;

struct LazyCfg {
  int window, literal, minp, wmask, lit_limit;
};

struct LazyStep {
  uint32_t v;  // the field's value
  int nb;      // its bits
  int next;    // the next position
  int defer;   // the next position is entered with a deferred match
  int pix, psz;  // the probe, cached when defer
  int err;     // an excess literal: the walk ends here
};

// One step of the walk at t with the match (idx, size) it sees: the cached
// one when t was entered with a deferred match, else P's.
__device__ __forceinline__ LazyStep lazy_step(int t, int32_t p, int32_t q,
                                              int idx, int size,
                                              const LazyCfg& c) {
  LazyStep r;
  r.pix = q & 0x7FFF;
  r.psz = q >> 15;
  const int tau = t & c.wmask;
  r.defer = size >= c.minp && size <= 8 && r.psz > size &&
            !(r.pix <= tau && tau < r.pix + r.psz);
  if (size >= c.minp && !r.defer) {
    const int sym = min(size - c.minp, 13);
    r.v = ((uint32_t)kHuffCode[sym] << c.window) | (uint32_t)idx;
    r.nb = kHuffLen[sym] + c.window;
    r.next = t + size;
    r.err = 0;
  } else {
    const int byte = p & 0xFF;
    r.v = (1u << c.literal) | (uint32_t)byte;
    r.nb = c.literal + 1;
    r.next = t + 1;
    r.err = byte >= c.lit_limit;
  }
  return r;
}

// The step of node (t, d) read from global memory (the maps and the erring
// node).  Node (0, 1) is never entered.
__device__ __forceinline__ LazyStep lazy_node_step(const int32_t* p_row,
                                                   const int32_t* q_row,
                                                   int t, int d,
                                                   const LazyCfg& c) {
  const int32_t p = p_row[t];
  int idx = (p >> 8) & 0x7FFF, size = p >> 23;
  if (d) {
    const int32_t qp = q_row[t - 1];
    idx = qp & 0x7FFF;
    size = qp >> 15;
  }
  return lazy_step(t, p, q_row[t], idx, size, c);
}

__global__ void __launch_bounds__(LAZY_MAP_THREADS)
lazy_maps_kernel(const int32_t* __restrict__ P, const int32_t* __restrict__ Q,
                 const int32_t* __restrict__ npos_arr,
                 int64_t* __restrict__ maps, int NP, LazyCfg c) {
  extern __shared__ int64_t F[];  // 2 * FT nodes
  const int s = blockIdx.y, k = blockIdx.x, base = k * FT;
  const int limit = min(npos_arr[s] - 15, NP);  // first position not walked
  if (base >= limit) return;                    // never entered
  const int N = 2 * min(FT, limit - base);      // local nodes walked
  const int32_t* p_row = P + (size_t)s * NP;
  const int32_t* q_row = Q + (size_t)s * NP;
  for (int n = threadIdx.x; n < N; n += LAZY_MAP_THREADS) {
    const int t = base + (n >> 1), d = n & 1;
    int f = n;  // node (0, 1): unreachable, its own exit
    int64_t bits = 0;
    if (t > 0 || !d) {
      const LazyStep r = lazy_node_step(p_row, q_row, t, d, c);
      bits = r.nb;
      f = r.err ? -1 - n : 2 * (r.next - base) + r.defer;
    }
    F[n] = (int64_t)((uint64_t)bits << 32 | (uint32_t)f);
  }
  __syncthreads();
  // pointer doubling (B3's): a chain in a tile has at most FT hops
  for (int r = 1; r < FT; r <<= 1) {
    for (int n = threadIdx.x; n < N; n += LAZY_MAP_THREADS) {
      const int64_t v = F[n];
      const int g = map_exit(v);
      if (g >= 0 && g < N) {
        const int64_t w = F[g];
        F[n] = (int64_t)((uint64_t)((v >> 32) + (w >> 32)) << 32 |
                         (uint32_t)map_exit(w));
      }
    }
    __syncthreads();
  }
  int64_t* m_row = maps + (size_t)s * 2 * NP + 2 * base;
  for (int n = threadIdx.x; n < N; n += LAZY_MAP_THREADS) {
    const int64_t v = F[n];
    const int g = map_exit(v);  // to global nodes: a sink is -1 - node
    m_row[n] = (int64_t)((uint64_t)(v >> 32) << 32 |
                         (uint32_t)(g < 0 ? g - 2 * base : g + 2 * base));
  }
}

// per-tile slots of the tiles workspace (int32 x TL_N)
constexpr int TL_ENTRY = 0, TL_CIDX = 1, TL_CSZ = 2, TL_N = 3;
// per-shard slots of the meta workspace (int64 x MT_N)
constexpr int MT_BITS = 0, MT_LAST = 1, MT_ERRV = 2, MT_ERRNB = 3, MT_N = 4;

__global__ void lazy_entries_kernel(const int32_t* __restrict__ P,
                                    const int32_t* __restrict__ Q,
                                    const int32_t* __restrict__ npos_arr,
                                    const int64_t* __restrict__ maps,
                                    int32_t* __restrict__ tiles,
                                    int64_t* __restrict__ off,
                                    int64_t* __restrict__ meta,
                                    int32_t* __restrict__ state, int NP,
                                    int n_tiles, LazyCfg c) {
  const int s = blockIdx.x;
  int32_t* t_row = tiles + (size_t)s * n_tiles * TL_N;
  for (int i = threadIdx.x; i < n_tiles; i += 32) {
    t_row[TL_N * i + TL_ENTRY] = -1;
    t_row[TL_N * i + TL_CIDX] = -1;
    t_row[TL_N * i + TL_CSZ] = 0;  // no deferral seen
  }
  __syncwarp();
  if (threadIdx.x != 0) return;
  const int npos = npos_arr[s];
  const int limit = min(npos - 15, NP);
  const int64_t* m_row = maps + (size_t)s * 2 * NP;
  int node = 0, last = -1;
  int64_t bits = 0;
  // a tile's exit lies in a later tile: at most n_tiles lookups
  for (int hop = 0; hop < n_tiles && node >= 0 && (node >> 1) < limit;
       ++hop) {
    const int k = (node >> 1) / FT;
    t_row[TL_N * k + TL_ENTRY] = node;
    off[(size_t)s * n_tiles + k] = bits;
    last = k;
    const int64_t v = m_row[node];
    bits += v >> 32;
    node = map_exit(v);
  }
  int64_t* mt = meta + (size_t)s * MT_N;
  mt[MT_BITS] = bits;
  mt[MT_LAST] = last;
  mt[MT_ERRV] = 0;
  mt[MT_ERRNB] = 0;
  if (node < 0) {  // the erring node's field, for S_ACC
    const int e = -1 - node;
    const LazyStep r = lazy_node_step(P + (size_t)s * NP, Q + (size_t)s * NP,
                                      e >> 1, e & 1, c);
    mt[MT_ERRV] = r.v;
    mt[MT_ERRNB] = r.nb;
  }
  int32_t* st = state + (size_t)s * NSLOTS;
  st[0] = node < 0 ? npos : node >> 1;
  st[1] = (int32_t)(bits >> 3);
  st[2] = 0;  // S_ACC, S_CIDX, S_CSZ: lazy_finish_kernel
  st[3] = (int32_t)(bits & 7);
  st[4] = -1;
  st[5] = 0;
  st[6] = node < 0 ? ERR_EXCESS : 0;
  for (int i = 7; i < NSLOTS; ++i) st[i] = 0;
}

__global__ void __launch_bounds__(LAZY_PACK_THREADS)
lazy_pack_kernel(const int32_t* __restrict__ P, const int32_t* __restrict__ Q,
                 const int32_t* __restrict__ npos_arr,
                 int32_t* __restrict__ tiles,
                 const int64_t* __restrict__ off,
                 const int64_t* __restrict__ meta,
                 uint32_t* __restrict__ words, int NP, int n_tiles, int nw,
                 LazyCfg c) {
  __shared__ int32_t sp[FT];
  __shared__ int32_t sq[FT];
  const int s = blockIdx.y, k = blockIdx.x, base = k * FT;
  int32_t* tl = tiles + ((size_t)s * n_tiles + k) * TL_N;
  const int node = tl[TL_ENTRY];
  if (node < 0) return;
  const int e = node >> 1;
  const int end = min(base + FT, min(npos_arr[s] - 15, NP));
  const int32_t* p_row = P + (size_t)s * NP;
  const int32_t* q_row = Q + (size_t)s * NP;
  for (int i = e + threadIdx.x; i < end; i += LAZY_PACK_THREADS) {
    sp[i - base] = p_row[i];
    sq[i - base] = q_row[i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t* w_row = words + (size_t)s * (nw + 1);  // [nw] is the tail slot
  const int64_t wf = meta[(size_t)s * MT_N + MT_BITS] >> 5;
  const int64_t p0 = off[(size_t)s * n_tiles + k];
  int64_t widx = p0 >> 5;
  int an = (int)(p0 & 31);  // the bits before the tile's first: zeros here
  uint64_t acc = 0;
  auto put = [&](uint32_t w) {  // the word widx, big-endian in memory
    if (widx < nw) atomicOr(&w_row[widx], __byte_perm(w, 0, 0x0123));
    if (widx == wf) atomicOr(&w_row[nw], w);
    ++widx;
  };
  int cidx = -1, csz = 0, seen = 0;
  if (node & 1) {  // entered with the probe of e - 1 deferred
    const int32_t qp = q_row[e - 1];
    cidx = qp & 0x7FFF;
    csz = qp >> 15;
    seen = csz;
  }
  for (int t = e; t < end;) {
    const int32_t p = sp[t - base];
    int idx = (p >> 8) & 0x7FFF, size = p >> 23;
    if (cidx >= 0) {
      idx = cidx;
      size = csz;
    }
    const LazyStep r = lazy_step(t, p, sq[t - base], idx, size, c);
    cidx = r.defer ? r.pix : -1;
    if (r.defer) seen = csz = r.psz;
    // the reference drains bytes: a value's bits above its field reach
    // back into the < 8 pending bits only
    const uint32_t v = r.v & (uint32_t)((1ull << (r.nb + (an & 7))) - 1);
    acc = (acc << r.nb) | v;
    an += r.nb;
    if (an >= 32) {
      put((uint32_t)(acc >> (an - 32)));
      an -= 32;
    }
    if (r.err) break;
    t = r.next;
  }
  if (an > 0) put((uint32_t)(acc << (32 - an)));  // the seam or last word
  tl[TL_CIDX] = cidx;
  tl[TL_CSZ] = seen;
}

__global__ void lazy_finish_kernel(const uint32_t* __restrict__ words,
                                   const int32_t* __restrict__ tiles,
                                   const int64_t* __restrict__ meta,
                                   uint8_t* __restrict__ out,
                                   int32_t* __restrict__ state, int max_out,
                                   int nw, int n_tiles) {
  const int s = blockIdx.y;
  const uint32_t* w_row = words + (size_t)s * (nw + 1);
  const int64_t* mt = meta + (size_t)s * MT_N;
  const int64_t bits = mt[MT_BITS];
  const int64_t n = min(bits >> 3, (int64_t)max_out);  // bytes that fit
  uint8_t* o_row = out + (size_t)s * max_out;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((max_out & 3) == 0 && ((uintptr_t)o_row & 3) == 0) {
    for (int64_t i = i0; i < n / 4; i += step)
      reinterpret_cast<uint32_t*>(o_row)[i] = w_row[i];
    const uint8_t* src = reinterpret_cast<const uint8_t*>(w_row);
    for (int64_t i = 4 * (n / 4) + i0; i < n; i += step) o_row[i] = src[i];
  } else {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(w_row);
    for (int64_t i = i0; i < n; i += step) o_row[i] = src[i];
  }
  if (i0 != 0) return;
  int32_t* st = state + (size_t)s * NSLOTS;
  const int an = (int)(bits & 7);
  uint32_t acc = 0;
  if (an) {
    const int used = (int)(bits & 31);  // the tail word's bits
    acc = (w_row[nw] >> (32 - used)) & ((1u << an) - 1);
    // an excess literal that drained no byte leaves its high bits in the
    // reference's accumulator
    if (an >= mt[MT_ERRNB] && mt[MT_ERRNB] > 0)
      acc |= (uint32_t)mt[MT_ERRV] & ~((1u << an) - 1);
  }
  st[2] = (int32_t)acc;
  const int last = (int)mt[MT_LAST];
  if (last < 0) return;  // no walk: the cache stays empty
  const int32_t* t_row = tiles + (size_t)s * n_tiles * TL_N;
  st[4] = t_row[TL_N * last + TL_CIDX];
  for (int k = last; k >= 0; --k)
    if (t_row[TL_N * k + TL_CSZ] != 0) {
      st[5] = t_row[TL_N * k + TL_CSZ];
      break;
    }
}

}  // namespace

extern "C" int tpt_commit_v1_lazy(const void* P, const void* Q,
                                  const void* npos, void* out, void* state,
                                  void* maps, void* tiles, void* off,
                                  void* meta, void* words, int S, int NP,
                                  int n_tiles, int max_out, int window,
                                  int literal, int minp, void* stream) {
  // the workspace is sized by the wrapper: tiles and off hold n_tiles rows
  if (n_tiles != (NP + FT - 1) / FT) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const LazyCfg c{window, literal, minp, (1 << window) - 1,
                  literal == 8 ? 256 : 1 << literal};
  const int nw = (max_out + 3) / 4;  // words that hold max_out bytes
  const int smem = 2 * FT * (int)sizeof(int64_t);
  cudaError_t e = cudaFuncSetAttribute(
      lazy_maps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (n_tiles > 0)
    lazy_maps_kernel<<<dim3(n_tiles, S), LAZY_MAP_THREADS, smem, st>>>(
        (const int32_t*)P, (const int32_t*)Q, (const int32_t*)npos,
        (int64_t*)maps, NP, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  lazy_entries_kernel<<<S, 32, 0, st>>>(
      (const int32_t*)P, (const int32_t*)Q, (const int32_t*)npos,
      (const int64_t*)maps, (int32_t*)tiles, (int64_t*)off, (int64_t*)meta,
      (int32_t*)state, NP, n_tiles, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (n_tiles > 0)
    lazy_pack_kernel<<<dim3(n_tiles, S), LAZY_PACK_THREADS, 0, st>>>(
        (const int32_t*)P, (const int32_t*)Q, (const int32_t*)npos,
        (int32_t*)tiles, (const int64_t*)off, (const int64_t*)meta,
        (uint32_t*)words, NP, n_tiles, nw, c);
  const int blocks = max(1, min(64, (nw + 255) / 256));
  lazy_finish_kernel<<<dim3(blocks, S), 256, 0, st>>>(
      (const uint32_t*)words, (const int32_t*)tiles, (const int64_t*)meta,
      (uint8_t*)out, (int32_t*)state, max_out, nw, n_tiles);
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
