// Kernels X3 and X4: the optimal (minimum-bit) parse DPs of the v1 and
// extended formats, as passes over blocks of B positions.
//
// Replaces the serial lax.scan loops of tamp_tpu/ops/opt_parse.py:66
// opt_v1_choice_device (X3: K = 16) and tamp_tpu/ops/opt_parse_ext.py:57
// opt_ext_choice_device (X4: K = minp + 131).  cost[p] is the least number
// of payload bits that codes positions p.. of a shard; it depends on
// cost[p + 1 .. p + K] through the edges of position p:
//   - advance 1 at weight w0: a literal (1 + literal bits; INF for a byte
//     wider than `literal` bits; 0 at or past npos, where positions are
//     free literals), or inside an X4 forced-RLE region the chunk-cost
//     chain weight;
//   - advances minp .. hi at the static token bits of a match of that size
//     (X3: hi = min(flen, minp + 13); X4: hi = min(flen, bound, room >=
//     minp + 12 ? room : minp + 11), none inside a region).
// Every sum saturates at INF = 2^26 - 64, so no int32 sum overflows, and
// saturation commutes with min-plus over non-negative weights: the output
// does not depend on B, and block products associate.  The combine keeps
// each boundary vector less its least entry (INF entries stay INF): the
// choice and `bad` do not see the shift, so costs stay relative to a few
// blocks and a shard of any length stays clear of INF; cost0 adds the
// shifts back, saturated at INF.
//
//   pass 1   one block of K columns per (shard, block of B positions):
//            column j is the block's first K costs as a function of entry
//            j of the next block's boundary vector (the min-plus identity
//            pushed through the block, right to left).  Thread j owns
//            column j and never reads another's, so no barrier runs while
//            a staged chunk of edges is walked; a step relaxes only the
//            edges that exist (advance 1 and minp..hi).  X3 keeps its
//            16-row ring in registers (16 threads a block, 8 blocks a
//            CTA), reads edge words staged once a CTA, and writes the
//            matrix column by column, T[blk][j][i].  X4 keeps rows 0..15
//            of each column in registers (every basic advance, up to
//            minp + 11 <= 14, reads them) and all K rows in a shared ring
//            written off the chain, read only by extended matches; its
//            edges are staged 256 positions at a time, so three 74 KB CTAs
//            fit on an SM; it writes T[blk][i][j].
//   combine  each block's incoming boundary vector.  X3: a two-level scan
//            (group products of G blocks in parallel, a serial pass over a
//            shard's n_b / G groups, then each group's blocks in
//            parallel), three launches.  X4: right to left over the blocks
//            on a cluster of 16 CTAs a shard, each streaming its slice of
//            rows and sending its entries of the vector into every CTA's
//            shared memory with st.async, counted on that CTA's mbarrier:
//            no cluster barrier a block.
//   pass 2   one thread per (shard, block), serial over its B positions
//            with exact costs: the choice is the lowest advance among the
//            minimal saturated costs (X3's score = cost * 32 + priority,
//            X4's argmin); `bad` is any in-shard position (X4: not inside
//            a region) whose cost is INF.  The edges' inputs of a warp's
//            32 blocks are staged ahead with cp.async and the near rows
//            kept in registers, so the walk reads no device memory; the
//            choices go out in coalesced stores.
//
// What bounds it on this card: the dependence chains (each position's cost
// needs the one after it, inside a block) and, in pass 1, the K x edges
// integer operations a position; bytes are a few per position.  X3's
// first port lost its time to a combine that was a chain of n_b = 1024
// steps a shard on 8 SMs, a pass 1 that reloaded and recomputed each
// position's edges in each of its 16 threads and relaxed all 15 advances,
// and a pass 2 of ~2 warps an SM on uncoalesced loads and stores.  The
// design spreads pass 1 over S * NP / B blocks, keeps the chains to B
// steps, and X3's combine to n_b / G + G steps a shard.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = (1 << 26) - 64;
// Huffman code lengths (flag bit included), symbols 0..14 (an extended
// match's second symbol reaches 14)
__constant__ int HL[15] = {2, 3, 5, 5, 6, 7, 7, 7, 8, 8, 9, 9, 9, 7, 9};

struct Cfg {
  int S, NP, B, n_b, window, literal, minp, lit_limit;
};

__host__ __device__ constexpr int tsize(int K) { return (K * K + 3) & ~3; }

// Token bits of an extended-format match of advance a (INF where no match
// has that size).
__device__ __forceinline__ int match_bits(const Cfg& c, int a) {
  if (a < c.minp) return INF;
  if (a <= c.minp + 11) return HL[a - c.minp] + c.window;
  return HL[13] + HL[(a - c.minp - 12) >> 3] - 1 + 3 + c.window;
}

struct Edges {
  int w0;      // weight of advance 1
  int hi;      // highest match advance (none below minp)
  bool count;  // an INF cost here makes the shard bad
};

// X4's edges of position p of shard s: plane = packed, data = the bytes or
// null (literal 8), cw = the chain weights.
template <int K>
__device__ __forceinline__ Edges edges(const Cfg& c, const int32_t* plane,
                                       const uint8_t* data,
                                       const int32_t* cw, int s, int p,
                                       int npos) {
  if (p >= npos) return {0, 0, false};
  const int64_t off = (int64_t)s * c.NP + p;
  int lc = 1 + c.literal;
  if (data != nullptr && data[off] >= c.lit_limit) lc = INF;
  const int v = plane[off];
  if (v < 0) return {cw[off], 0, false};  // interior: the chain edge only
  const int room = ((v >> 8) & 0x7FFF) + 1;
  int hi = min(min(v & 0xFF, (v >> 23) & 0xFF), K);
  hi = min(hi, room >= c.minp + 12 ? room : c.minp + 11);
  return {lc, hi, true};
}

// ---- X3, pass 1: 16 threads a block, P1_BLK blocks a CTA -------------------
// Thread j of a block owns column j and keeps its 16-row ring in registers:
// row i (cost[p + 1 + i]) at step u of a 16-step group in r[(i - u) mod
// 16], the group unrolled, so every index is static.  The CTA stages its
// blocks' edges P1_CH positions at a time in shared memory, one word a
// position (w0 | hi << HI_SHIFT) in step order, each thread loading its own
// block's positions (no division), and the 16 threads of a block read a
// group's 16 words as four 16-byte broadcasts.  A match advance above hi is
// skipped by an early exit, uniform for the 16 threads of a block (the two
// blocks of a warp diverge only where their positions' hi differ).  The
// matrix is written column by column: T[blk][j][i].
constexpr int P1_BLK = 8;          // blocks a CTA of pass 1
constexpr int P1_CH = 256;         // positions a staged chunk
constexpr int P1_LD = P1_CH + 4;   // a block's staged row (the two blocks of
                                   // a warp on different banks)
constexpr int HI_SHIFT = 26;       // w0 < 2^26 (INF included), hi <= 16

// The edge word of in-block position p of a block starting at `off` in
// the planes: w0 | hi << HI_SHIFT (0 at or past npos: a free literal).
__device__ __forceinline__ int v1_edge(const Cfg& c,
                                       const int32_t* __restrict__ flen,
                                       const uint8_t* __restrict__ data,
                                       int64_t off, int p, int np) {
  if (p >= np) return 0;
  const int w0 = data[off + p] < c.lit_limit ? 1 + c.literal : INF;
  const int hi = min(max(flen[off + p], 0), c.minp + 13);
  return w0 | hi << HI_SHIFT;
}

template <int MINP>
__global__ void __launch_bounds__(P1_BLK * 16)
v1_pass1(Cfg c, const int32_t* __restrict__ flen,
         const uint8_t* __restrict__ data, const int32_t* __restrict__ npos,
         int32_t* __restrict__ T) {
  __shared__ __align__(16) int stage[P1_BLK * P1_LD];
  const int j = threadIdx.x & 15, kb = threadIdx.x >> 4;
  const int blk = blockIdx.x * P1_BLK + kb;
  const bool real = blk < c.S * c.n_b;
  const int s = real ? blk / c.n_b : 0;
  const int pend = real ? (blk % c.n_b + 1) * c.B : 0;
  const int np = real ? npos[s] - (pend - c.B) : 0;  // in-block npos
  const int64_t off = (int64_t)s * c.NP + (pend - c.B);
  int wt[14];  // token bits of a match of size MINP + b
#pragma unroll
  for (int b = 0; b < 14; b++) wt[b] = HL[b] + c.window;
  int r[16];
#pragma unroll
  for (int i = 0; i < 16; i++) r[i] = i == j ? 0 : INF;
  int* row = stage + kb * P1_LD;
  for (int q0 = 0; q0 < c.B; q0 += P1_CH) {
    const int n = min(P1_CH, c.B - q0);  // a multiple of 16
    __syncthreads();  // the last chunk is read
    if (real)
#pragma unroll 4
      for (int u = j; u < n; u += 16) row[u] = v1_edge(c, flen, data, off,
                                                      c.B - 1 - q0 - u, np);
    __syncthreads();
    if (!real) continue;
    for (int q = 0; q < n; q += 16) {
      int e[16];
#pragma unroll
      for (int k = 0; k < 4; k++) {
        const int4 v = *reinterpret_cast<const int4*>(row + q + 4 * k);
        e[4 * k] = v.x;
        e[4 * k + 1] = v.y;
        e[4 * k + 2] = v.z;
        e[4 * k + 3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < 16; u++) {
        const int hi = e[u] >> HI_SHIFT;
        int nv = r[(16 - u) % 16] + (e[u] & ((1 << HI_SHIFT) - 1));
#pragma unroll
        for (int b = 0; b < 14; b++) {
          if (MINP + b > hi) break;
          nv = min(nv, r[(MINP + b - 1 - u + 16) % 16] + wt[b]);
        }
        r[15 - u] = min(nv, INF);
      }
    }
  }
  if (!real) return;
  // after B (a multiple of 16) steps, row i is back in r[i]
  int4* out = reinterpret_cast<int4*>(T + (int64_t)blk * 256 + j * 16);
#pragma unroll
  for (int i = 0; i < 4; i++)
    out[i] = make_int4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
}

// ---- pass 1, X4: a 16-row register window per column --------------------
// Column j (thread j) keeps rows 0..15 of its ring in registers, row i at
// step u of a 16-step group in r[(i - u) mod 16] (the group is unrolled, so
// every index is static), and all K rows in a shared ring (written every
// step, off the chain), read only by the extended advances >= minp + 12
// (rows >= 13).  The basic advances minp..minp + 11 reach row 13 at most.
// A step's edge count is the same for every column (hi is the position's),
// so the early exit of the unrolled edge loop is uniform.  The edges are
// staged CH1 positions at a time, so three CTAs fit on an SM.  The matrix
// is written row by row: T[blk][i][j].
constexpr int CH1 = 256;  // positions a staged chunk of pass 1
constexpr int WIN = 16;   // rows a column keeps in registers

template <int K>
constexpr size_t pass1_smem() {
  return ((size_t)((K * K + 1) & ~1) + 2 * CH1 + K + 1) * sizeof(int);
}

template <int K>
__global__ void __launch_bounds__(K, 3)
pass1_ext(Cfg c, const int32_t* plane, const uint8_t* data,
          const int32_t* cw, const int32_t* npos, int32_t* T) {
  constexpr int MINP = K - 131;
  extern __shared__ int4 smem4[];
  int* ring = reinterpret_cast<int*>(smem4);
  int2* stage = reinterpret_cast<int2*>(ring + ((K * K + 1) & ~1));
  int* wx = reinterpret_cast<int*>(stage + CH1);
  const int j = threadIdx.x;
  const int blk = blockIdx.x;
  const int s = blk / c.n_b, pend = (blk % c.n_b + 1) * c.B;
  const int np = npos[s];
  int wb[12];  // the basic advances' token bits
#pragma unroll
  for (int b = 0; b < 12; b++) wb[b] = match_bits(c, MINP + b);
  for (int a = j; a <= K; a += K) wx[a] = match_bits(c, a);
  for (int i = 0; i < K; i++) ring[i * K + j] = i == j ? 0 : INF;
  int r[WIN];
#pragma unroll
  for (int i = 0; i < WIN; i++) r[i] = i == j ? 0 : INF;
  int top = 0;  // the ring row of row 0
  for (int q0 = 0; q0 < c.B; q0 += CH1) {
    __syncthreads();  // the last chunk's edges are read
    for (int k = j; k < CH1; k += K) {
      const Edges e = edges<K>(c, plane, data, cw, s,
                                     pend - 1 - q0 - k, np);
      stage[k] = make_int2(e.w0, e.hi);
    }
    __syncthreads();
    for (int q = 0; q < CH1; q += WIN) {
      int2 es[WIN];  // the group's edges, loaded together
#pragma unroll
      for (int u = 0; u < WIN; u++) es[u] = stage[q + u];
#pragma unroll
      for (int u = 0; u < WIN; u++) {
        const int2 e = es[u];
        int m = INF;  // the match advances first: off the chain
#pragma unroll
        for (int b = 0; b < 12; b++) {
          if (MINP + b > e.y) break;
          m = min(m, r[(MINP + b - 1 - u + WIN) % WIN] + wb[b]);
        }
        if (e.y >= MINP + 12) {  // extended matches (rare): the ring
          for (int a = MINP + 12; a <= e.y; a++) {
            int idx = top + a - 1;
            if (idx >= K) idx -= K;
            m = min(m, ring[idx * K + j] + wx[a]);
          }
        }
        const int nv = min(min(m, r[(WIN - u) % WIN] + e.x), INF);
        top = top == 0 ? K - 1 : top - 1;
        ring[top * K + j] = nv;
        r[WIN - 1 - u] = nv;
      }
    }
  }
  __syncthreads();
  int32_t* Tb = T + (int64_t)blk * tsize(K);
  for (int i = 0; i < K; i++) {
    int ph = top + i;
    if (ph >= K) ph -= K;
    Tb[i * K + j] = ring[ph * K + j];
  }
}

// ---- X3, the combine: a two-level scan over groups of G blocks ------------
// The min-plus product is associative and saturation at INF commutes with
// it, so the boundary vectors come from three launches instead of a chain
// of n_b matrix-vector steps a shard:
//   v1_group   a CTA a (shard, group of G blocks): the group's matrices in
//              shared memory (columns padded to 17: no bank conflicts), a
//              thread an entry multiplies them right to left, and the
//              group's product replaces its first block's matrix, which no
//              later launch reads;
//   v1_scan    a warp a shard: right to left over its groups' products,
//              writing each group's incoming vector into the bounds of the
//              group's last block, then cost0;
//   v1_bounds  a warp a group: right to left over its blocks from that
//              vector, writing the others' bounds.
// In a matrix-vector step lane l takes row l & 15 and columns 8 (l >> 4)
// .. + 7, the vector is read by shuffles and the halves meet by one; the
// matrices of a chain stream through shared memory with cp.async several
// steps ahead.  A shard's chain is n_b / G + G steps; a group of one block
// (n_b = 1, or the last group) has nothing to multiply.
constexpr int G = 32;       // blocks a group
constexpr int BW = 4;       // warps a CTA of v1_bounds
constexpr int CH_NST = 8;   // matrices in flight in a chain
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(256)
v1_group(int n_b, int n_g, int32_t* __restrict__ T) {
  __shared__ int m[G][16 * 17];
  __shared__ int P[16 * 17];
  const int s = blockIdx.x / n_g, b0 = (blockIdx.x % n_g) * G;
  const int nb = min(G, n_b - b0);
  if (nb == 1) return;
  int32_t* Tg = T + ((int64_t)s * n_b + b0) * 256;
  for (int x = threadIdx.x; x < nb * 256; x += 256)
    m[x >> 8][(x >> 4 & 15) * 17 + (x & 15)] = Tg[x];
  __syncthreads();
  const int i = threadIdx.x & 15, j = threadIdx.x >> 4;
  int acc = m[nb - 1][j * 17 + i];
  for (int b = nb - 2; b >= 0; --b) {
    __syncthreads();  // the last product is read
    P[j * 17 + i] = acc;
    __syncthreads();
    int v = INF;
#pragma unroll
    for (int k = 0; k < 16; k++) v = min(v, m[b][k * 17 + i] + P[j * 17 + k]);
    acc = v;
  }
  Tg[threadIdx.x] = acc;  // entry (i, j) at j * 16 + i
}

// lane's part of matrix b's row: columns 8 h .. 8 h + 7 of row i
__device__ __forceinline__ void v1_row(const int* __restrict__ Tb, int i,
                                       int h, int (&x)[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) x[k] = Tb[(8 * h + k) * 16 + i];
}

// one matrix-vector step: row i of M (x) v, v[k] held by lanes k and k + 16
// (a min tree: the step is on the chain)
__device__ __forceinline__ int v1_apply(const int (&x)[8], int v, int h) {
  int y[8];
#pragma unroll
  for (int k = 0; k < 8; k++) y[k] = x[k] + __shfl_sync(FULL, v, 8 * h + k);
#pragma unroll
  for (int w = 1; w < 8; w *= 2)
#pragma unroll
    for (int k = 0; k + w < 8; k += 2 * w) y[k] = min(y[k], y[k + w]);
  return min(min(y[0], __shfl_xor_sync(FULL, y[0], 16)), INF);
}

// v less its least entry over the warp (INF entries stay INF; a vector of
// INF stays as it is), the shift added to `off`
__device__ __forceinline__ int v1_rebase(int v, long long& off) {
  const int m = __reduce_min_sync(FULL, v);
  if (m >= INF) return v;
  off += m;
  return v >= INF ? INF : v - m;
}

// A warp's chain v <- M_t (x) v for t = 0 .. n - 1, M_t at mat(t), calling
// put(t, v) with v rebased (its shifts summed in `off`) before step t.  The
// matrices stream through `ring` (CH_NST slots of 256 ints) with cp.async,
// CH_NST - 1 steps ahead, so a step waits on no device-memory load.
template <class Mat, class Put>
__device__ __forceinline__ int v1_chain(int n, int v, long long& off,
                                        int (*ring)[256], Mat mat, Put put) {
  const int lane = threadIdx.x & 31, i = lane & 15, h = lane >> 4;
  auto fetch = [&](int t) {
    if (t < n) {
      const int4* src = reinterpret_cast<const int4*>(mat(t));
      int4* dst = reinterpret_cast<int4*>(ring[t % CH_NST]);
      __pipeline_memcpy_async(dst + lane, src + lane, 16);
      __pipeline_memcpy_async(dst + 32 + lane, src + 32 + lane, 16);
    }
    __pipeline_commit();
  };
  for (int t = 0; t < CH_NST - 1; t++) fetch(t);
  for (int t = 0; t < n; t++) {
    fetch(t + CH_NST - 1);
    __pipeline_wait_prior(CH_NST - 1);
    __syncwarp();
    v = v1_rebase(v, off);
    put(t, v);
    int x[8];
    v1_row(ring[t % CH_NST], i, h, x);
    v = v1_apply(x, v, h);
    __syncwarp();  // slot t % CH_NST is read before step t + 1 refills it
  }
  return v;
}

__global__ void __launch_bounds__(32)
v1_scan(int n_b, int n_g, const int32_t* __restrict__ T,
        int32_t* __restrict__ bounds, int32_t* __restrict__ cost0) {
  __shared__ __align__(16) int ring[CH_NST][256];
  const int s = blockIdx.x, i = threadIdx.x & 15, h = threadIdx.x >> 4;
  const int32_t* Ts = T + (int64_t)s * n_b * 256;
  int32_t* bs = bounds + (int64_t)s * n_b * 16;
  // step t: group n_g - 1 - t, its product at its first block; before it,
  // the group's incoming vector is its last block's bounds
  long long off = 0;
  const int v = v1_chain(
      n_g, 0, off, ring,
      [&](int t) { return Ts + (int64_t)(n_g - 1 - t) * G * 256; },
      [&](int t, int x) {
        if (h == 0) bs[(min((n_g - t) * G, n_b) - 1) * 16 + i] = x;
      });
  if (threadIdx.x == 0) cost0[s] = (int)min(off + v, (long long)INF);
}

__global__ void __launch_bounds__(32 * BW)
v1_bounds(int n_b, int n_g, int n_grp, const int32_t* __restrict__ T,
          int32_t* __restrict__ bounds) {
  __shared__ __align__(16) int ring[BW][CH_NST][256];
  const int w = blockIdx.x * BW + (threadIdx.x >> 5);
  if (w >= n_grp) return;
  const int s = w / n_g, b0 = (w % n_g) * G, last = min(b0 + G, n_b) - 1;
  const int i = threadIdx.x & 15, h = (threadIdx.x >> 4) & 1;
  const int32_t* Ts = T + (int64_t)s * n_b * 256;
  int32_t* bs = bounds + (int64_t)s * n_b * 16;
  // step t applies block last - t, whose bounds are the vector before it
  long long off = 0;
  int v = v1_chain(
      last - b0, bs[last * 16 + i], off, ring[threadIdx.x >> 5],
      [&](int t) { return Ts + (int64_t)(last - t) * 256; },
      [&](int t, int x) {
        if (t > 0 && h == 0) bs[(last - t) * 16 + i] = x;
      });
  v = v1_rebase(v, off);
  if (last > b0 && h == 0) bs[b0 * 16 + i] = v;
}

// ---- X3, pass 2: one thread a block, 32 a CTA ------------------------------
// Each lane walks its block right to left with exact costs from its
// boundary vector, the 16-row ring in registers (scaled by 32, rotated as
// in pass 1).  The flen words and data bytes of the warp's 32 blocks are
// staged V2_CH positions ahead with cp.async on padded rows (V2_LP = 33:
// lane l reads column l, no bank conflicts), so no device-memory load sits
// on the walk.  A candidate's key is min(cost, INF) * 32 + its priority
// (0 for the literal, s - minp + 1 for a match of size s), unsigned so the
// literal's r + INF * 32 cannot overflow, and one min tree picks the least
// cost and, among equals, the literal, then the lowest size: the JAX
// function's score.  The choices go out a chunk at a time in coalesced
// stores, int32 (the wrapper's contract).
constexpr int V2_CH = 32;  // positions a staged chunk of pass 2
constexpr int V2_LP = 33;  // a staged row: 32 blocks + 1

template <int MINP>
__global__ void __launch_bounds__(32)
v1_pass2(Cfg c, const int32_t* __restrict__ flen,
         const uint8_t* __restrict__ data, const int32_t* __restrict__ npos,
         const int32_t* __restrict__ bounds, int32_t* __restrict__ choice,
         int32_t* __restrict__ bad) {
  constexpr int NQ = V2_CH + V2_CH / 4;  // staged rows a buffer
  constexpr unsigned INFK = (unsigned)INF * 32;
  __shared__ int stg[2][NQ][V2_LP];
  __shared__ int chs[V2_CH][V2_LP];
  const int lane = threadIdx.x;
  const int nblk = c.S * c.n_b, blk0 = blockIdx.x * 32, blk = blk0 + lane;
  const int nb = min(32, nblk - blk0);  // real blocks of the warp
  const bool real = lane < nb;
  const int s = real ? blk / c.n_b : 0;
  const int pend = real ? (blk % c.n_b + 1) * c.B : c.B;
  const int np = real ? npos[s] - (pend - c.B) : 0;  // in-block npos
  // the lane's block's first position in the planes; the warp's 32 are
  // passed round by shuffles
  const long long base0 = (long long)s * c.NP + (pend - c.B);
  unsigned ck[14];  // 32 * token bits + priority of a match of MINP + b
#pragma unroll
  for (int b = 0; b < 14; b++) ck[b] = (HL[b] + c.window) * 32 + b + 1;
  const unsigned lit = (1 + c.literal) * 32;
  unsigned r[16];
#pragma unroll
  for (int i = 0; i < 16; i++)
    r[i] = real ? bounds[(int64_t)blk * 16 + i] * 32u : 0u;
  const int nq = (c.B + V2_CH - 1) / V2_CH;
  // chunk q holds in-block offsets [B - q V2_CH - n, B - q V2_CH)
  auto chunk = [&](int q, int& n, int& off) {
    n = min(V2_CH, c.B - q * V2_CH);
    off = c.B - q * V2_CH - n;
  };
  auto issue = [&](int q) {
    if (q < nq) {
      int n, off;
      chunk(q, n, off);
      for (int b = 0; b < nb; b++) {
        const long long base = __shfl_sync(FULL, base0, b) + off;
        if (lane < n)
          __pipeline_memcpy_async(&stg[q & 1][lane][b], flen + base + lane,
                                  4);
        if (lane < n / 4)
          __pipeline_memcpy_async(&stg[q & 1][V2_CH + lane][b],
                                  data + base + 4 * lane, 4);
      }
    }
    __pipeline_commit();
  };
  bool flag = false;
  issue(0);
  for (int q = 0; q < nq; q++) {
    issue(q + 1);
    __pipeline_wait_prior(1);
    __syncwarp();
    int n, off;
    chunk(q, n, off);
    const int(*st)[V2_LP] = stg[q & 1];
    for (int k0 = 0; k0 < n; k0 += 16) {
#pragma unroll
      for (int u = 0; u < 16; u++) {
        const int x = n - 1 - k0 - u;  // the staged row of this position
        const bool in = off + x < np;
        const int by = (st[V2_CH + (x >> 2)][lane] >> (8 * (x & 3))) & 0xFF;
        const int hi = in ? min(st[x][lane], MINP + 13) : 0;
        const unsigned w0 = !in ? 0u : by >= c.lit_limit ? INFK : lit;
        unsigned key[15];
        key[0] = min(r[(16 - u) % 16] + w0, INFK);
#pragma unroll
        for (int b = 0; b < 14; b++) {
          const unsigned y =
              min(r[(MINP + b - 1 - u + 16) % 16] + ck[b], INFK + b + 1);
          key[b + 1] = MINP + b <= hi ? y : ~0u;
        }
#pragma unroll
        for (int h = 1; h < 15; h *= 2)
#pragma unroll
          for (int b = 0; b + h < 15; b += 2 * h)
            key[b] = min(key[b], key[b + h]);
        const unsigned best = key[0];
        const int pri = best & 31;
        flag |= in && best >= INFK;
        chs[x][lane] = pri == 0 ? 1 : pri - 1 + MINP;
        r[15 - u] = best & ~31u;
      }
    }
    __syncwarp();
    for (int b = 0; b < nb; b++) {
      int32_t* out = choice + __shfl_sync(FULL, base0, b) + off;
      if (lane < n) out[lane] = chs[lane][b];
    }
    __syncwarp();
  }
  if (real && flag) atomicOr(bad + s, 1);
}

// ---- combine, X4: a cluster of CL CTAs per shard --------------------------
// CTA `rank` owns rows [rank * R, rank * R + R) of every matrix: it streams
// those rows (contiguous in T[blk][i][j]) with cp.async, CNST blocks ahead,
// a warp a row takes v[i] = min_j T[i][j] + v[j] (lanes split j, one
// warp-wide min), and lanes 0..CL-1 store v[i] into the next vector of
// every CTA of the cluster with st.async, which counts its bytes on that
// CTA's mbarrier of the vector.  A CTA waits on its own mbarrier for the K
// entries of the next vector: no cluster-wide barrier a block.  The
// vectors are double-buffered; a CTA can send vector t + 2 into a buffer
// only once every CTA has sent its rows of vector t + 1, each after
// reading vector t, so no buffer is written while it is read.
constexpr int CL = 16;    // CTAs a shard (a non-portable cluster size)
constexpr int CNST = 12;  // blocks in flight

template <int K>
__host__ __device__ constexpr int crow() { return (K + CL - 1) / CL; }

template <int K>
constexpr size_t combine_smem() {
  return ((size_t)CNST * crow<K>() * K + 2 * K + 4) * sizeof(int);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wait for phase `parity` of an mbarrier whose bytes other CTAs deliver;
// trap (a launch error, not a hang) if they have not come in ~2^31 cycles
__device__ __forceinline__ void vec_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok = 0;
  const long long t0 = clock64();
  while (!ok) {
    if (clock64() - t0 > (1ll << 31)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void vec_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

template <int K>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(256)
combine_ext(int n_b, const int32_t* T, int32_t* bounds, int32_t* cost0) {
  constexpr int R = crow<K>(), TS = tsize(K);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);  // [2]
  int* buf = reinterpret_cast<int*>(smem4) + 4;        // [CNST][R * K]
  int* v = buf + CNST * R * K;                         // [2][K]
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / CL, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i0 = rank * R, nr = max(0, min(R, K - i0));
  const int32_t* Ts = T + (int64_t)s * n_b * TS + i0 * K;
  auto fetch = [&](int t) {  // the rows of the t-th block from the right
    if (t < n_b) {
      const int32_t* src = Ts + (int64_t)(n_b - 1 - t) * TS;
      int* dst = buf + (t % CNST) * R * K;
      for (int x = tid; x < nr * K; x += blockDim.x)
        __pipeline_memcpy_async(dst + x, src + x, 4);
    }
    __pipeline_commit();
  };
  for (int t = 0; t < CNST - 1; t++) fetch(t);
  for (int x = tid; x < K; x += blockDim.x) v[x] = 0;
  if (tid == 0) {
    // buffer 1 takes vectors 1, 3, ..., buffer 0 vectors 2, 4, ...
    for (int b = 0; b < 2; b++) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&bar[b]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    vec_expect(&bar[1], K * 4);
    if (n_b >= 2) vec_expect(&bar[0], K * 4);
  }
  cluster.sync();
  long long off = 0;  // the shifts taken off the vectors so far
  for (int t = 0; t < n_b; t++) {
    __pipeline_wait_prior(CNST - 2);
    __syncthreads();  // block t's rows landed; block t - 1's are read
    fetch(t + CNST - 1);
    if (t > 0) {
      vec_wait(&bar[t & 1], ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 2 <= n_b) vec_expect(&bar[t & 1], K * 4);
    }
    const int* cur = v + (t & 1) * K;
    const int* Tb = buf + (t % CNST) * R * K;
    // the vector's least entry, found alike by each warp that has rows
    // (one without reads nothing: other CTAs may refill the buffer before
    // it would): the vector is used less it (INF entries stay INF)
    int m = 0;
    if (warp < nr) {
      m = INF;
      for (int jj = lane; jj < K; jj += 32) m = min(m, cur[jj]);
      m = __reduce_min_sync(0xFFFFFFFFu, m);
      if (m >= INF) m = 0;
    }
    off += m;  // read by rank 0's thread 0 (warp 0 has rows there)
    auto rel = [&](int jj) { return cur[jj] >= INF ? INF : cur[jj] - m; };
    for (int x = tid; x < nr; x += blockDim.x)
      bounds[((int64_t)s * n_b + n_b - 1 - t) * K + i0 + x] = rel(i0 + x);
    const int nxt = (t + 1) & 1;
    for (int r = warp; r < nr; r += blockDim.x >> 5) {
      int nv = INF;
      for (int jj = lane; jj < K; jj += 32)
        nv = min(nv, Tb[r * K + jj] + rel(jj));
      nv = __reduce_min_sync(0xFFFFFFFFu, nv);
      if (lane < CL) {  // into CTA `lane`'s next vector
        uint32_t dst = smem_u32(v + nxt * K + i0 + r), rb = smem_u32(&bar[nxt]);
        asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n"
                     : "+r"(dst) : "r"(lane));
        asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n"
                     : "+r"(rb) : "r"(lane));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
            "[%0], %1, [%2];\n" ::"r"(dst),
            "r"(nv), "r"(rb)
            : "memory");
      }
    }
  }
  // the last vector: every CTA waits for it, so no store lands after exit
  vec_wait(&bar[n_b & 1], ((n_b - 1) >> 1) & 1);
  if (rank == 0 && tid == 0)
    cost0[s] = (int)min(off + v[(n_b & 1) * K], (long long)INF);
  cluster.sync();
}

// ---- pass 2, X4: one thread per block, 32 a CTA ---------------------------
// Each lane walks its block with exact costs from the block's boundary
// vector, rows 0..15 in registers (shifted a step: the loop body stays one
// step long) and all K rows in a shared ring for the extended advances.  The edges' inputs (packed word, chain
// weight, byte) of the warp's 32 blocks are staged CH2 positions ahead with
// cp.async, so no device-memory load sits on the walk; the choices go out
// a chunk at a time in coalesced stores.  The match advances are compared
// first (ascending, strict), then the literal edge, which wins ties.
constexpr int CH2 = 64;   // positions a staged chunk of pass 2
constexpr int LP = 33;    // a staged row: 32 blocks + 1 (no bank conflicts)

template <int K>
constexpr size_t pass2_smem() {
  return ((size_t)K * 32 + 2 * (2 * CH2 + CH2 / 4) * LP + K + 1)
             * sizeof(int) + CH2 * LP;
}

template <int K>
__global__ void __launch_bounds__(32)
pass2_ext(Cfg c, const int32_t* plane, const uint8_t* data,
          const int32_t* cw, const int32_t* npos, const int32_t* bounds,
          uint8_t* choice, int32_t* bad) {
  constexpr int MINP = K - 131;
  constexpr int NQ = 2 * CH2 + CH2 / 4;  // staged rows a buffer
  extern __shared__ int4 smem4[];
  int* ring = reinterpret_cast<int*>(smem4);  // [K][32]
  int* stg = ring + K * 32;                    // [2][NQ][LP]
  int* wx = stg + 2 * NQ * LP;                 // [K + 1]
  uint8_t* chs = reinterpret_cast<uint8_t*>(wx + K + 1);  // [CH2][LP]
  const int lane = threadIdx.x;
  const int nblk = c.S * c.n_b;
  const int blk0 = blockIdx.x * 32;
  const int blk = blk0 + lane;
  const bool real = blk < nblk;
  const int s = real ? blk / c.n_b : 0;
  const int pend = real ? (blk % c.n_b + 1) * c.B : 0;
  const int np = real ? npos[s] : 0;
  const bool lit8 = data == nullptr;
  for (int a = lane; a <= K; a += 32) wx[a] = match_bits(c, a);
  int wb[12];
#pragma unroll
  for (int b = 0; b < 12; b++) wb[b] = match_bits(c, MINP + b);
  // stage chunk q (in-block offsets [B - (q + 1) * CH2, B - q * CH2)) of
  // every block of the warp: row x of a buffer holds offset base + x
  // the lane's block's first position in the planes; the warp's 32 are
  // passed round by shuffles (no division in the staging loops)
  const long long base0 = (long long)s * c.NP + (long long)(pend - c.B);
  auto issue = [&](int q) {
    int* dst = stg + (q & 1) * NQ * LP;
    const int off = c.B - (q + 1) * CH2;
    for (int b = 0; b < 32 && blk0 + b < nblk; b++) {
      const long long base = __shfl_sync(0xFFFFFFFFu, base0, b) + off;
      for (int x = lane; x < CH2; x += 32) {
        __pipeline_memcpy_async(dst + x * LP + b, plane + base + x, 4);
        __pipeline_memcpy_async(dst + (CH2 + x) * LP + b, cw + base + x, 4);
      }
      if (!lit8 && lane < CH2 / 4)
        __pipeline_memcpy_async(dst + (2 * CH2 + lane) * LP + b,
                                data + base + 4 * lane, 4);
    }
    __pipeline_commit();
  };
  for (int i = 0; i < K; i++)
    ring[i * 32 + lane] = real ? bounds[(int64_t)blk * K + i] : 0;
  int r[WIN];
#pragma unroll
  for (int i = 0; i < WIN; i++) r[i] = ring[i * 32 + lane];
  int top = 0;
  bool flag = false;
  const int nq = c.B / CH2;
  issue(0);
  for (int q = 0; q < nq; q++) {
    if (q + 1 < nq) issue(q + 1);
    else __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncwarp();
    const int* st = stg + (q & 1) * NQ * LP;
#pragma unroll 4
    for (int k = 0; k < CH2; k++) {
      const int x = CH2 - 1 - k;  // the staged row of this position
      const int p = pend - 1 - q * CH2 - k;
      // the edges, with selects only (a branch costs a single warp dear)
      const int v = st[x * LP + lane];
      const int by = lit8 ? 0
                          : (st[(2 * CH2 + (x >> 2)) * LP + lane]
                             >> (8 * (x & 3))) & 0xFF;
      const int chain = st[(CH2 + x) * LP + lane];
      const bool in = p < np, count = in && v >= 0;
      const int room = ((v >> 8) & 0x7FFF) + 1;
      int hi = min(min(v & 0xFF, (v >> 23) & 0xFF), K);
      hi = count ? min(hi, room >= MINP + 12 ? room : MINP + 11) : 0;
      const int w0 = !in ? 0
                     : v < 0 ? chain  // interior: the chain edge
                     : by >= c.lit_limit ? INF
                                         : 1 + c.literal;
      // the best basic match: keys cost * 16 + (advance - minp), so one
      // min tree finds the least cost and, among equals, the lowest
      // advance (a key stays below 2^30)
      int key[12];
#pragma unroll
      for (int b = 0; b < 12; b++) {
        const int y = min(r[MINP + b - 1] + wb[b], INF);
        key[b] = MINP + b <= hi ? y * 16 + b : INF * 16 + 15;
      }
#pragma unroll
      for (int h = 1; h < 12; h *= 2)
#pragma unroll
        for (int b = 0; b + h < 12; b += 2 * h)
          key[b] = min(key[b], key[b + h]);
      int bm = key[0] >> 4, bc = MINP + (key[0] & 15);
      for (int a = MINP + 12; a <= hi; a++) {  // extended: ascending
        int idx = top + a - 1;
        if (idx >= K) idx -= K;
        const int y = min(ring[idx * 32 + lane] + wx[a], INF);
        if (y < bm) {
          bm = y;
          bc = a;
        }
      }
      const int lc = min(r[0] + w0, INF);
      const int best = lc <= bm ? lc : bm;
      flag |= count && best >= INF;
      chs[x * LP + lane] = (uint8_t)(lc <= bm ? 1 : bc);
      top = top == 0 ? K - 1 : top - 1;
      ring[top * 32 + lane] = best;
#pragma unroll
      for (int i = WIN - 1; i > 0; i--) r[i] = r[i - 1];
      r[0] = best;
    }
    __syncwarp();
    // the chunk's choices, CH2 contiguous bytes a block
    const int off = c.B - (q + 1) * CH2;
    for (int b = 0; b < 32 && blk0 + b < nblk; b++) {
      uint8_t* out = choice + __shfl_sync(0xFFFFFFFFu, base0, b) + off;
      for (int x = lane; x < CH2; x += 32) out[x] = chs[x * LP + b];
    }
    __syncwarp();
  }
  if (real && flag) atomicOr(bad + s, 1);
}

Cfg make_cfg(int S, int NP, int B, int window, int literal) {
  Cfg c;
  c.S = S;
  c.NP = NP;
  c.B = B;
  c.n_b = NP / B;
  c.window = window;
  c.literal = literal;
  c.minp = 2 + (window > 10 + ((literal - 5) << 1) ? 1 : 0);
  c.lit_limit = literal == 8 ? 256 : 1 << literal;
  return c;
}

template <int K>
int run_ext(const Cfg& c, const int32_t* packed, const uint8_t* data,
            const int32_t* npos, const int32_t* cw, uint8_t* choice,
            int32_t* cost0, int32_t* bad, int32_t* T, int32_t* bounds,
            cudaStream_t st) {
  if (c.B % CH1 != 0 || c.NP % c.B != 0) return (int)cudaErrorInvalidValue;
  const int nblk = c.S * c.n_b;
  cudaError_t e = cudaFuncSetAttribute(
      pass1_ext<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pass1_smem<K>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pass1_ext<K>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        combine_ext<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)combine_smem<K>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        combine_ext<K>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        pass2_ext<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)pass2_smem<K>());
  if (e != cudaSuccess) return (int)e;
  pass1_ext<K><<<nblk, K, pass1_smem<K>(), st>>>(c, packed, data, cw, npos,
                                                  T);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  combine_ext<K><<<c.S * CL, 256, combine_smem<K>(), st>>>(c.n_b, T, bounds,
                                                          cost0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  pass2_ext<K><<<(nblk + 31) / 32, 32, pass2_smem<K>(), st>>>(
      c, packed, data, cw, npos, bounds, choice, bad);
  return (int)cudaGetLastError();
}

template <int MINP>
int run_v1(const Cfg& c, const int32_t* flen, const uint8_t* data,
           const int32_t* npos, int32_t* choice, int32_t* cost0,
           int32_t* bad, int32_t* T, int32_t* bounds, cudaStream_t st) {
  const int nblk = c.S * c.n_b, n_g = (c.n_b + G - 1) / G;
  v1_pass1<MINP><<<(nblk + P1_BLK - 1) / P1_BLK, P1_BLK * 16, 0, st>>>(
      c, flen, data, npos, T);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  v1_group<<<c.S * n_g, 256, 0, st>>>(c.n_b, n_g, T);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  v1_scan<<<c.S, 32, 0, st>>>(c.n_b, n_g, T, bounds, cost0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  v1_bounds<<<(c.S * n_g + BW - 1) / BW, 32 * BW, 0, st>>>(
      c.n_b, n_g, c.S * n_g, T, bounds);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  v1_pass2<MINP><<<(nblk + 31) / 32, 32, 0, st>>>(c, flen, data, npos,
                                                   bounds, choice, bad);
  return (int)cudaGetLastError();
}

}  // namespace

// X3.  flen (S, NP) int32, data (S, NP) uint8 (4-byte aligned), npos (S,);
// out: choice (S, NP) int32, cost0 (S,), bad (S,) int32 (zeroed by the
// caller); scratch: T (S * NP / B * 256) and bounds (S * NP / B * 16)
// int32.  B divides NP and is a multiple of 16.
extern "C" int tpt_opt_v1_choice(const void* flen, const void* data,
                                 const void* npos, void* choice, void* cost0,
                                 void* bad, void* T, void* bounds, int S,
                                 int NP, int B, int window, int literal,
                                 void* stream) {
  const Cfg c = make_cfg(S, NP, B, window, literal);
  if (B % 16 != 0 || NP % B != 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  auto run = c.minp == 2 ? run_v1<2> : run_v1<3>;
  return run(c, (const int32_t*)flen, (const uint8_t*)data,
             (const int32_t*)npos, (int32_t*)choice, (int32_t*)cost0,
             (int32_t*)bad, (int32_t*)T, (int32_t*)bounds,
             (cudaStream_t)stream);
}

// X4.  packed (S, NP) int32, data (S, NP) uint8 or null (literal 8), npos
// (S,), cw (S, NP) int32 chain weights; out: choice (S, NP) uint8, cost0,
// bad (zeroed by the caller); scratch: T (S * NP / B * tsize(K)) and bounds
// (S * NP / B * K) int32, K = minp + 131.  B divides NP.
extern "C" int tpt_opt_ext_choice(const void* packed, const void* data,
                                  const void* npos, const void* cw,
                                  void* choice, void* cost0, void* bad,
                                  void* T, void* bounds, int S, int NP,
                                  int B, int window, int literal,
                                  void* stream) {
  const Cfg c = make_cfg(S, NP, B, window, literal);
  cudaStream_t st = (cudaStream_t)stream;
  auto* args = (const int32_t*)packed;
  if (c.minp == 2)
    return run_ext<133>(c, args, (const uint8_t*)data, (const int32_t*)npos,
                        (const int32_t*)cw, (uint8_t*)choice,
                        (int32_t*)cost0, (int32_t*)bad, (int32_t*)T,
                        (int32_t*)bounds, st);
  return run_ext<134>(c, args, (const uint8_t*)data, (const int32_t*)npos,
                      (const int32_t*)cw, (uint8_t*)choice, (int32_t*)cost0,
                      (int32_t*)bad, (int32_t*)T, (int32_t*)bounds, st);
}
