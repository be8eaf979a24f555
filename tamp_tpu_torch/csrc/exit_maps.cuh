// The tile-parallel front of the port's serial walks (B3 and B6 in
// encode_commit.cu, B7 in greedy_predict.cu, B8 in decode_wavefront.cu,
// B4's front in decode_commit.cu), and the grid rule of every kernel that
// takes blocks a shard.
//
// Each walk is a chain a shard, c -> next(c), whose next step depends on
// the words at c alone, so it resolves over tiles in parallel.  The maps: a
// tile computes, for each position where a chain can enter it, its exit
// (the first position at or past its end, or a stop) and the weight of the
// steps on the way, by pointer doubling over map words (B3, B6, B7) or one
// lane for each of its first SPAN bits (B4, B8: a step of at most 63 bits
// enters there).  The entries: one thread a shard follows the maps from tile
// to tile, recording each visited tile's entry and prefix weight.  The
// pack: each visited tile walks its own chain from its entry.
//
// The grid rule: shard s's blocks are s * n_blocks + b in grid row x, which
// holds 2^31 - 1 blocks (rows y and z hold 65535, fewer than the shards of
// a batch of tiny shards).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ShardBlock {
  int s, b;  // a block's shard, and its block among the shard's
};

__device__ __forceinline__ ShardBlock shard_block(int n_blocks) {
  return {(int)(blockIdx.x / n_blocks), (int)(blockIdx.x % n_blocks)};
}

// kernel on S x n_blocks blocks under the grid rule: nothing for an empty
// grid, cudaErrorInvalidValue where the blocks pass row x
template <typename... P, typename... A>
cudaError_t launch_shards(void (*kernel)(P...), int S, int n_blocks,
                          int threads, size_t smem, cudaStream_t st,
                          A... args) {
  if (S <= 0 || n_blocks <= 0) return cudaSuccess;
  if ((long long)S * n_blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  kernel<<<(unsigned)(S * n_blocks), threads, smem, st>>>(
      static_cast<P>(args)...);
  return cudaGetLastError();
}

// tile[from .. n) = src[from .. n), 16 bytes a load where src is 16-byte
// aligned
template <int THREADS>
__device__ __forceinline__ void stage_words(int32_t* tile,
                                            const int32_t* __restrict__ src,
                                            int from, int n) {
  int i = from + threadIdx.x;
  if (((uintptr_t)src & 15) == 0) {
    for (int v = (from >> 2) + threadIdx.x; v < n >> 2; v += THREADS)
      reinterpret_cast<int4*>(tile)[v] = reinterpret_cast<const int4*>(src)[v];
    i = (n & ~3) + threadIdx.x;
  }
  for (; i < n; i += THREADS) tile[i] = src[i];
}

constexpr int ENT_STAGE = 32768;  // bytes of maps an entries walk stages

// The entries walk of one shard: its tiles' maps, KEEP a tile (m_row), are
// staged ENT_STAGE bytes at a time by the block's THREADS threads, and
// thread 0 follows them from entry e of tile 0 (e < 0: none is entered):
// visit(k, e) records visited tile k's entry, hop(k, map) adds its map's
// weights and returns the chain's entry in tile k + 1, or -1 where it
// stops.  A chain leaves a tile into the next one, so the visited tiles are
// a prefix of the row; thread 0 returns their count.
template <int THREADS, int KEEP, typename Map, typename Visit, typename Hop>
__device__ __forceinline__ int walk_entries(const Map* __restrict__ m_row,
                                            int n_tiles, int e, Visit visit,
                                            Hop hop) {
  constexpr int CHUNK = ENT_STAGE / (KEEP * (int)sizeof(Map));
  static_assert(KEEP * sizeof(Map) % 16 == 0, "16-byte staging");
  __shared__ __align__(16) Map m[CHUNK * KEEP];
  __shared__ int stopped;
  if (threadIdx.x == 0) stopped = e < 0;
  __syncthreads();
  int k = 0;
  for (int k0 = 0; k0 < n_tiles && !stopped; k0 += CHUNK) {
    const int n16 = min(CHUNK, n_tiles - k0) * KEEP * (int)sizeof(Map) / 16;
    const uint4* src =
        reinterpret_cast<const uint4*>(m_row + (size_t)k0 * KEEP);
    for (int i = threadIdx.x; i < n16; i += THREADS)
      reinterpret_cast<uint4*>(m)[i] = src[i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (; k < min(k0 + CHUNK, n_tiles) && !stopped; ++k) {
        visit(k, e);
        e = hop(k, m[(k - k0) * KEEP + e]);
        stopped = e < 0;
      }
    }
    __syncthreads();  // the verdict, and m is free to be overwritten
  }
  return k;
}

// ---- the doubling front (B3, B6, B7) ----

constexpr int FT = 4096;   // positions a tile
constexpr int FENT = 256;  // entry positions that keep a map (a step <= 255)

// a map word: weight << 32 | exit (a position, or a sink < 0)
__device__ __forceinline__ int64_t map_word(int64_t weight, int exit) {
  return (int64_t)((uint64_t)weight << 32 | (uint32_t)exit);
}

__device__ __forceinline__ int map_exit(int64_t v) {
  return (int)(uint32_t)(uint64_t)v;
}

__device__ __forceinline__ int64_t map_weight(int64_t v) { return v >> 32; }

// F[0 .. n) in shared memory: first(i), the map word of entry i's step (an
// exit in [0, n) is an entry of the tile, any other ends the chain), becomes
// entry i's exit map by pointer doubling.  A chain in a tile takes fewer
// than FT steps, so log2(FT) rounds do.  In place is safe: every value is a
// valid map of its entry, and a later one only reaches further along.
template <int THREADS, typename First>
__device__ __forceinline__ void double_maps(int64_t* F, int n, First first) {
  for (int i = threadIdx.x; i < n; i += THREADS) F[i] = first(i);
  __syncthreads();
  for (int r = 1; r < FT; r <<= 1) {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int64_t v = F[i];
      const int g = map_exit(v);
      if (g >= 0 && g < n) {
        const int64_t w = F[g];
        F[i] = map_word(map_weight(v) + map_weight(w), map_exit(w));
      }
    }
    __syncthreads();
  }
}

// row[o] = entry o's map for o < n_keep, its exit in the shard's numbering
// (+ off, a sink - sink_off); an entry at or past n is its own exit
template <int THREADS>
__device__ __forceinline__ void store_maps(const int64_t* F,
                                           int64_t* __restrict__ row, int n,
                                           int n_keep, int off, int sink_off) {
  for (int o = threadIdx.x; o < n_keep; o += THREADS) {
    const int64_t v = o < n ? F[o] : map_word(0, o);
    const int g = map_exit(v);
    row[o] = map_word(map_weight(v), g < 0 ? g - sink_off : g + off);
  }
}

// The maps launch of B3 and B7, a block a (shard, tile), whose steps reach
// at most 255 positions: first(s, base, i), the map word of the step at
// position base + i of shard s, its exit local to the tile.  The walk stops
// at the first position at or past npos - 15.
template <int THREADS, typename First>
__device__ __forceinline__ void position_maps(
    const int32_t* __restrict__ npos_arr, int64_t* __restrict__ maps, int NP,
    int n_tiles, First first) {
  __shared__ int64_t F[FT];
  const ShardBlock p = shard_block(n_tiles);
  const int base = p.b * FT;
  const int limit = min(npos_arr[p.s] - 15, NP);  // first position not walked
  if (base >= limit) return;                      // never entered
  const int E = min(FT, limit - base);            // positions walked
  double_maps<THREADS>(F, E, [&](int i) { return first(p.s, base, i); });
  store_maps<THREADS>(F, maps + ((size_t)p.s * n_tiles + p.b) * FENT, E,
                      FENT, base, 0);
}

// The entries walk over FENT maps a tile with absolute exits (B3, B7): at[k]
// the entry position of each visited tile, -1 elsewhere, and off[k] the
// weight before it.  The chain stops at a sink or at limit, its last exit
// in `stop`; thread 0 returns the weight.
template <int THREADS, typename Off>
__device__ __forceinline__ int64_t walk_positions(
    const int64_t* __restrict__ m_row, int n_tiles, int limit,
    int32_t* __restrict__ at, Off* __restrict__ off, int& stop) {
  for (int i = threadIdx.x; i < n_tiles; i += THREADS) at[i] = -1;
  int64_t weight = 0;
  stop = 0;
  walk_entries<THREADS, FENT>(
      m_row, n_tiles, limit > 0 ? 0 : -1,
      [&](int k, int e) {
        at[k] = k * FT + e;
        off[k] = (Off)weight;
      },
      [&](int k, int64_t v) {
        weight += map_weight(v);
        stop = map_exit(v);
        return stop >= 0 && stop < limit ? stop - (k + 1) * FT : -1;
      });
  return weight;
}

// ---- the lane front (B4, B8) ----

constexpr int LANE_TILE = 4096;  // words a tile, at most
constexpr int SPAN = 64;         // entry bits of a tile that keep a map
constexpr int X_STOP = SPAN;     // map exit codes past the offsets
constexpr int X_ERR = SPAN + 1;
constexpr int LANE_MAP_THREADS = 128;
constexpr int LANE_ENT_THREADS = 256;
constexpr int LANE_PACK_THREADS = 128;

// The chain from bit c of the tile staged in `tile` (bits [base, end)):
// step(word, c) returns the next bit, or -1 where the chain stops.  Returns
// the first bit at or past end, or -1.
template <typename Step>
__device__ __forceinline__ int walk_tile(const int32_t* tile, int base,
                                         int end, int c, Step step) {
  while (c >= 0 && c < end) c = step(tile[c - base], c);
  return c;
}

// The maps launch, a block a (shard, tile of ct words of plane (S, NBP)):
// lane j < SPAN walks the chain from the tile's bit j and keeps map(x) for
// its exit code x: the exit's offset past the tile's end, X_STOP where the
// chain stops in the tile or the tile ends the plane, X_ERR where a hop
// lands SPAN or more bits past the end (no parse of the port makes one).
template <typename Map, typename Step, typename Keep>
__device__ __forceinline__ void lane_maps(const int32_t* __restrict__ plane,
                                          Map* __restrict__ maps, int NBP,
                                          int n_tiles, int ct, Step step,
                                          Keep map) {
  __shared__ __align__(16) int32_t tile[LANE_TILE];
  const ShardBlock p = shard_block(n_tiles);
  const int base = p.b * ct, end = min(base + ct, NBP);
  stage_words<LANE_MAP_THREADS>(tile, plane + (size_t)p.s * NBP + base, 0,
                                end - base);
  __syncthreads();
  if (threadIdx.x >= SPAN) return;
  const int c = walk_tile(tile, base, end, base + threadIdx.x, step);
  const int x = c < end || end >= NBP ? X_STOP
                : c - end < SPAN      ? c - end
                                      : X_ERR;
  maps[((size_t)p.s * n_tiles + p.b) * SPAN + threadIdx.x] = map(x);
}

// The pack of a visited tile (bits [base, end) of its shard's `row`,
// entered at bit base + e): its words from e on are staged, and thread 0
// walks the chain with step, which writes each record.
template <typename Step>
__device__ __forceinline__ void pack_tile(const int32_t* __restrict__ row,
                                          int base, int end, int e,
                                          Step step) {
  __shared__ __align__(16) int32_t tile[LANE_TILE];
  stage_words<LANE_PACK_THREADS>(tile, row + base, e, end - base);
  __syncthreads();
  if (threadIdx.x == 0) walk_tile(tile, base, end, base + e, step);
}

}  // namespace
