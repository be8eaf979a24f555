// Kernels B8 (token-boundary chase) and X1 (window-write truncation
// deficits) of the wavefront decode modes.
//
// B8 replaces the TPU kernel tamp_tpu/ops/token_chase_pallas.py::_kernel
// (via token_table_chase).  Per shard, the orbit of the per-bit jump array
// nxt (S, NBP) from bit 0 is the list of real token starts: c = 0, then
// c = nxt[c] while c < NBP.  A bit whose nxt is NBP or more is an
// incomplete trailing token: it is dropped and the chase ends there.  A hop
// that does not advance (nxt[c] <= c) ends the chase as well (the parse
// never makes one; the guard keeps malformed input from spinning).
// Output: the starts in order, compact, in starts (S, T_max) (slots at or
// past T_max dropped; the wrapper zero-fills the rest), and their count
// clipped to T_max in T (S,).
//
// What bounds B8 on this card: as one chase a shard (the first port), its
// dependence chain, each hop one load whose address is the previous load's
// value, on 8 of 132 SMs.  But the next start depends only on the word at
// c, so c -> nxt[c] is a function on bit positions and the chase resolves
// in parallel as B3's and B7's walks do; what is left is bytes (the plane
// read once by the maps, each visited tile's words once more by the pack,
// the starts written once) and a few operations a hop.
//
// Design: three launches on the caller's stream over tiles of CT bits:
//   1. chase_maps_kernel: per tile, the tile's words staged in shared
//      memory, one lane for each of its first SPAN bits walks the chain
//      from there to its exit, the first position at or past the tile's
//      end, counting the starts on the way.  A token is at most 35 bits
//      (ops/decode_wavefront.py: BLOCK_BITS, ENTRY_SPAN), so a chain enters
//      a tile at one of its first SPAN bits and only those maps are kept.
//      A map word is its exit code | count << 8: the exit's offset past the
//      tile end (< SPAN), X_STOP (the chain stopped in the tile), or X_ERR
//      (a hop landed SPAN or more bits past the tile end: no parse makes
//      that, and the map cannot carry it).
//   2. chase_entries_kernel: per shard, one lookup a tile, over maps staged
//      in shared memory ENT_CHUNK tiles at a time, gives each visited tile
//      its entry bit and its output offset (the prefix of the counts); the
//      visited tiles are a prefix of the row, because an exit lands in the
//      next tile.  It writes T, the number of visited tiles, and an error
//      flag when the chase met X_ERR (the wrapper raises).
//   3. chase_pack_kernel: every visited tile stages its words from its
//      entry on and walks its chain from its entry, writing its starts from
//      its offset, in order.
// The wrapper (ops/token_chase.token_table_chase) allocates the workspace
// with torch.  The TPU kernel's 512-bit SMEM tiles, per-tile output rows
// and the scatter that compacts them answer the TPU's SMEM and are not
// carried over.
//
// X1 replaces the serial lax.while_loop `tr_body` of
// tamp_tpu/ops/decode_wavefront.py::_wavefront_finish.  Over the truncating
// tokens of a shard (RLE and extended matches, compacted by the caller into
// seg_c, s_c, w_c: segment id, segment-relative untruncated write offset,
// untruncated write count), in order:
//   D = 0 where the segment changes; room = W - ((s - D) mod W);
//   d = max(0, w - room); D += d; defs_c[i] = d.
// What bounds X1: the chain through D, a few integer operations a token,
// and, in its first port (one thread a shard, 8 shards on one warp), one
// device-memory latency a token: its loads sat in a loop of runtime bound.
// Design: a CTA a shard.  Its threads stage the shard's three rows
// TR_TILE tokens at a time into shared memory with cp.async, the next tile
// in flight while warp 0 resolves the current one 32 tokens a pass by
// speculation: every lane takes D as it stood before the first unresolved
// token, or 0 where a segment change lies between, and computes its d; a
// ballot finds the first lane whose d > 0, every lane up to it is exact
// (the ones before it have d = 0), D and the segment advance to that lane
// and the pass repeats after it.  D changes only by a nonzero d or a
// segment reset, so a chunk costs one pass plus one a nonzero deficit, and
// nonzero deficits are rare (an RLE writes at most 8 bytes, an extended
// match far fewer than W, into a ring of W).  The deficits go out a chunk
// at a time in coalesced stores.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 4096;         // bits of nxt a tile
constexpr int SPAN = 64;         // entry bits of a tile that keep a map
constexpr int X_STOP = SPAN;     // map exit codes past the offsets
constexpr int X_ERR = SPAN + 1;
constexpr int MAP_THREADS = 128;
constexpr int ENT_THREADS = 256;
constexpr int ENT_CHUNK = 64;    // tiles whose maps are staged at once
constexpr int PACK_THREADS = 128;

__global__ void __launch_bounds__(MAP_THREADS)
chase_maps_kernel(const int32_t* __restrict__ nxt, int32_t* __restrict__ maps,
                  int NBP, int n_tiles) {
  __shared__ int32_t tile[CT];
  const int s = blockIdx.y, k = blockIdx.x, base = k * CT;
  const int end = min(base + CT, NBP);
  const int32_t* row = nxt + (size_t)s * NBP;
  for (int i = threadIdx.x; i < end - base; i += MAP_THREADS)
    tile[i] = row[base + i];
  __syncthreads();
  if (threadIdx.x >= SPAN) return;
  int c = base + threadIdx.x, cnt = 0, x = X_STOP;
  // an entry at or past NBP is never taken: the hop there stops first
  while (c < end) {
    const int n = tile[c - base];
    if (n >= NBP || n <= c) break;  // stop: x stays X_STOP
    ++cnt;
    c = n;
    // only a tile that ends before NBP can be left
    if (c >= end) x = c - end < SPAN ? c - end : X_ERR;
  }
  maps[((size_t)s * n_tiles + k) * SPAN + threadIdx.x] = x | cnt << 8;
}

__global__ void __launch_bounds__(ENT_THREADS)
chase_entries_kernel(const int32_t* __restrict__ maps,
                     int32_t* __restrict__ ent, int32_t* __restrict__ T,
                     int32_t* __restrict__ info, int n_tiles, int T_max) {
  __shared__ int32_t m[ENT_CHUNK * SPAN];
  __shared__ int stopped;
  const int s = blockIdx.x;
  const int32_t* m_row = maps + (size_t)s * n_tiles * SPAN;
  int32_t* e_row = ent + (size_t)s * 2 * n_tiles;  // entry bits, offsets
  int k = 0, e = 0, total = 0, err = 0;  // meaningful in thread 0
  if (threadIdx.x == 0) stopped = 0;
  for (int k0 = 0; k0 < n_tiles; k0 += ENT_CHUNK) {
    const int nk = min(ENT_CHUNK, n_tiles - k0);
    for (int i = threadIdx.x; i < nk * SPAN; i += ENT_THREADS)
      m[i] = m_row[(size_t)k0 * SPAN + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (; k < k0 + nk && !stopped; ++k) {
        e_row[k] = e;
        e_row[n_tiles + k] = total;
        const int v = m[(k - k0) * SPAN + e];
        total += v >> 8;
        e = v & 255;
        if (e >= X_STOP) {
          stopped = 1;
          err = e == X_ERR;
        }
      }
    }
    __syncthreads();  // the verdict, and m is free to be overwritten
    if (stopped) break;
  }
  if (threadIdx.x == 0) {
    T[s] = min(total, T_max);
    info[2 * s] = k;  // tiles visited
    info[2 * s + 1] = err;
  }
}

__global__ void __launch_bounds__(PACK_THREADS)
chase_pack_kernel(const int32_t* __restrict__ nxt,
                  const int32_t* __restrict__ ent,
                  const int32_t* __restrict__ info,
                  int32_t* __restrict__ starts, int NBP, int n_tiles,
                  int T_max) {
  __shared__ int32_t tile[CT];
  const int s = blockIdx.y, k = blockIdx.x, base = k * CT;
  if (k >= info[2 * s]) return;  // not visited
  const int32_t* e_row = ent + (size_t)s * 2 * n_tiles;
  const int e = e_row[k];
  int o = e_row[n_tiles + k];
  if (o >= T_max) return;  // every start of this tile is dropped
  const int end = min(base + CT, NBP);
  const int32_t* row = nxt + (size_t)s * NBP;
  for (int i = e + threadIdx.x; i < end - base; i += PACK_THREADS)
    tile[i] = row[base + i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  int32_t* srow = starts + (size_t)s * T_max;
  for (int c = base + e; c < end && o < T_max;) {
    const int n = tile[c - base];
    if (n >= NBP || n <= c) break;
    srow[o++] = c;
    c = n;
  }
}

constexpr int TR_TILE = 1024;    // tokens of a shard staged at a time
constexpr int TR_THREADS = 128;

// The deficits of one chunk of 32 tokens (lane l: token l, valid below m;
// sg, sv, wv its segment, offset and count), from D and the segment `cur`
// of the token before the chunk, which it leaves at the chunk's last
// token.  A pass gives each unresolved token D, or 0 where a segment
// change lies between it and the first unresolved token, and resolves
// every token up to the first whose deficit is nonzero (the ones before
// it have d = 0, so their D is exact).
__device__ __forceinline__ int fold_chunk(int sg, int sv, int wv, int m,
                                          int W, int& D, int& cur) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int up = __shfl_up_sync(FULL, sg, 1);
  const unsigned chg = __ballot_sync(FULL, sg != (lane == 0 ? cur : up));
  const unsigned le = (2u << lane) - 1;  // lanes 0..lane
  int out = 0;
  for (int pos = 0; pos < m;) {
    const bool reset = (chg & le) >> pos != 0;
    const int Dl = reset ? 0 : D;
    const int d = max(0, wv - (W - ((sv - Dl) & (W - 1))));
    const unsigned hit = __ballot_sync(FULL, lane >= pos && lane < m && d);
    const int f = hit ? __ffs(hit) - 1 : m - 1;
    if (lane >= pos && lane <= f) out = d;
    D = __shfl_sync(FULL, Dl + d, f);
    cur = __shfl_sync(FULL, sg, f);
    pos = f + 1;
  }
  return out;
}

__global__ void __launch_bounds__(TR_THREADS)
trunc_deficits_kernel(const int32_t* __restrict__ seg_c,
                      const int32_t* __restrict__ s_c,
                      const int32_t* __restrict__ w_c,
                      const int32_t* __restrict__ n_tr,
                      int32_t* __restrict__ defs_c, int T_max, int W) {
  __shared__ int32_t tile[2][3][TR_TILE];
  const size_t off = (size_t)blockIdx.x * T_max;
  const int n = n_tr[blockIdx.x];
  const int nt = (n + TR_TILE - 1) / TR_TILE;
  auto issue = [&](int t) {
    if (t < nt) {
      const int base = t * TR_TILE, m = min(TR_TILE, n - base);
      for (int i = threadIdx.x; i < m; i += TR_THREADS) {
        __pipeline_memcpy_async(&tile[t & 1][0][i], seg_c + off + base + i,
                                4);
        __pipeline_memcpy_async(&tile[t & 1][1][i], s_c + off + base + i, 4);
        __pipeline_memcpy_async(&tile[t & 1][2][i], w_c + off + base + i, 4);
      }
    }
    __pipeline_commit();
  };
  issue(0);
  int D = 0, cur = 0;  // warp 0's
  for (int t = 0; t < nt; ++t) {
    issue(t + 1);
    __pipeline_wait_prior(1);
    __syncthreads();  // tile t landed
    if (threadIdx.x < 32) {
      const int base = t * TR_TILE, m = min(TR_TILE, n - base);
      const int(*rows)[TR_TILE] = tile[t & 1];
      for (int c = 0; c < m; c += 32) {
        const int i = c + threadIdx.x;
        const bool in = i < m;
        const int d = fold_chunk(in ? rows[0][i] : 0, in ? rows[1][i] : 0,
                                 in ? rows[2][i] : 0, min(32, m - c), W, D,
                                 cur);
        if (in) defs_c[off + base + i] = d;
      }
    }
    __syncthreads();  // tile t is read: issue(t + 2) may overwrite it
  }
}

}  // namespace

// maps (S, n_tiles, SPAN), ent (S, 2, n_tiles) and info (S, 2) int32 are
// the wrapper's workspace; info[s] = (tiles visited, error flag)
extern "C" int tpt_token_chase(const void* nxt, void* starts, void* T,
                               void* maps, void* ent, void* info, int S,
                               int NBP, int T_max, int n_tiles,
                               void* stream) {
  if (n_tiles != (NBP + CT - 1) / CT) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles > 0)
    chase_maps_kernel<<<dim3(n_tiles, S), MAP_THREADS, 0, st>>>(
        (const int32_t*)nxt, (int32_t*)maps, NBP, n_tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chase_entries_kernel<<<S, ENT_THREADS, 0, st>>>(
      (const int32_t*)maps, (int32_t*)ent, (int32_t*)T, (int32_t*)info,
      n_tiles, T_max);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (n_tiles > 0)
    chase_pack_kernel<<<dim3(n_tiles, S), PACK_THREADS, 0, st>>>(
        (const int32_t*)nxt, (const int32_t*)ent, (const int32_t*)info,
        (int32_t*)starts, NBP, n_tiles, T_max);
  return (int)cudaGetLastError();
}

// defs_c (S, T_max) zeroed by the caller; entries at or past n_tr[s] are
// not written
extern "C" int tpt_trunc_deficits(const void* seg_c, const void* s_c,
                                  const void* w_c, const void* n_tr,
                                  void* defs_c, int S, int T_max, int W,
                                  void* stream) {
  if (S == 0) return (int)cudaSuccess;
  trunc_deficits_kernel<<<S, TR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)seg_c, (const int32_t*)s_c, (const int32_t*)w_c,
      (const int32_t*)n_tr, (int32_t*)defs_c, T_max, W);
  return (int)cudaGetLastError();
}
