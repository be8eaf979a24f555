// Kernels X3 and X4: the optimal (minimum-bit) parse DPs of the v1 and
// extended formats, as three passes over blocks of B positions.
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
// does not depend on B.
//
//   pass 1   one block of K columns per (shard, block of B positions):
//            column j is the block's first K costs as a function of entry
//            j of the next block's boundary vector (the min-plus identity
//            pushed through the block, right to left).  Thread j owns
//            column j and never reads another's, so no barrier runs while
//            a staged chunk of edges is walked.  Each step relaxes only the
//            edges that exist (advance 1 and minp..hi), the same number
//            for every thread of the block: no divergence.  X3 keeps its
//            16-row ring in registers (16 threads a block, 8 blocks a
//            CTA) and writes the matrix column by column, T[blk][j][i].
//            X4 keeps rows 0..15 of each column in registers (every basic
//            advance, up to minp + 11 <= 14, reads them) and all K rows in
//            a shared ring written off the chain, read only by extended
//            matches; its edges are staged 256 positions at a time, so
//            three 74 KB CTAs fit on an SM; it writes T[blk][i][j].
//   combine  X3: one CTA per shard, thread i owns row i: right to left over
//            the blocks, write the block's incoming boundary vector, then
//            v[i] = min_j T[i][j] + v[j], the matrices streamed through
//            shared memory with cp.async, several blocks ahead.  X4: the
//            same product spread over a cluster of 16 CTAs a shard, each
//            streaming its slice of rows and sending its entries of the
//            vector into every CTA's shared memory with st.async, counted
//            on that CTA's mbarrier: no cluster barrier a block.
//   pass 2   one thread per (shard, block), serial over its B positions
//            with exact costs: the choice is the lowest advance among the
//            minimal saturated costs (X3's score = cost * 32 + priority,
//            X4's argmin); `bad` is any in-shard position (X4: not inside
//            a region) whose cost is INF.  X4's edges' inputs are staged
//            ahead with cp.async and its near rows kept in registers, so
//            the walk reads no device memory.
//
// What bounds it on this card: the dependence chains (each position's cost
// needs the one after it, inside a block) and, in pass 1, the K x edges
// integer operations a position; bytes are a few per position.  The design
// spreads pass 1 over S * NP / B blocks and keeps the chains to B steps.

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

// Token bits of a match of advance a (INF where no match has that size).
template <bool EXT>
__device__ __forceinline__ int match_bits(const Cfg& c, int a) {
  if (a < c.minp) return INF;
  if (!EXT) return a <= c.minp + 13 ? HL[a - c.minp] + c.window : INF;
  if (a <= c.minp + 11) return HL[a - c.minp] + c.window;
  return HL[13] + HL[(a - c.minp - 12) >> 3] - 1 + 3 + c.window;
}

struct Edges {
  int w0;      // weight of advance 1
  int hi;      // highest match advance (none below minp)
  bool count;  // an INF cost here makes the shard bad
};

// The edges of position p of shard s.  X3: plane = flen, data = the bytes;
// X4: plane = packed, data = the bytes or null (literal 8), cw = the chain
// weights.
template <bool EXT, int K>
__device__ __forceinline__ Edges edges(const Cfg& c, const int32_t* plane,
                                       const uint8_t* data,
                                       const int32_t* cw, int s, int p,
                                       int npos) {
  if (p >= npos) return {0, 0, false};
  const int64_t off = (int64_t)s * c.NP + p;
  int lc = 1 + c.literal;
  if (data != nullptr && data[off] >= c.lit_limit) lc = INF;
  const int v = plane[off];
  if (!EXT) return {lc, min(v, c.minp + 13), true};
  if (v < 0) return {cw[off], 0, false};  // interior: the chain edge only
  const int room = ((v >> 8) & 0x7FFF) + 1;
  int hi = min(min(v & 0xFF, (v >> 23) & 0xFF), K);
  hi = min(hi, room >= c.minp + 12 ? room : c.minp + 11);
  return {lc, hi, true};
}

// ---- pass 1, registers (X3): 16 threads a block ---------------------------
// Row i (cost[p + 1 + i]) of the ring at step k lives in r[(i - k) mod K];
// the loop is unrolled by K, so every index is static (B is a multiple of
// K).
template <int K, bool EXT>
__global__ void __launch_bounds__(128)
pass1_regs(Cfg c, const int32_t* plane, const uint8_t* data,
           const int32_t* cw, const int32_t* npos, int32_t* T) {
  const int j = threadIdx.x % K;
  const int blk = blockIdx.x * (blockDim.x / K) + threadIdx.x / K;
  if (blk >= c.S * c.n_b) return;
  const int s = blk / c.n_b, pend = (blk % c.n_b + 1) * c.B;
  const int np = npos[s];
  int wt[K + 1];
#pragma unroll
  for (int a = 0; a <= K; a++) wt[a] = match_bits<EXT>(c, a);
  int r[K];
#pragma unroll
  for (int i = 0; i < K; i++) r[i] = i == j ? 0 : INF;
  for (int q = 0; q < c.B; q += K) {
#pragma unroll
    for (int u = 0; u < K; u++) {
      const Edges e = edges<EXT, K>(c, plane, data, cw, s, pend - 1 - q - u,
                                    np);
      int nv = r[(K - u) % K] + e.w0;
#pragma unroll
      for (int a = 2; a <= K; a++) {
        const int x = r[(a - 1 - u + K) % K] + wt[a];
        nv = min(nv, a <= e.hi ? x : INF);
      }
      r[K - 1 - u] = min(nv, INF);
    }
  }
  // after B (a multiple of K) steps, row i is back in r[i]
  int4* out = reinterpret_cast<int4*>(T + (int64_t)blk * tsize(K) + j * K);
#pragma unroll
  for (int i = 0; i < K / 4; i++)
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
  for (int b = 0; b < 12; b++) wb[b] = match_bits<true>(c, MINP + b);
  for (int a = j; a <= K; a += K) wx[a] = match_bits<true>(c, a);
  for (int i = 0; i < K; i++) ring[i * K + j] = i == j ? 0 : INF;
  int r[WIN];
#pragma unroll
  for (int i = 0; i < WIN; i++) r[i] = i == j ? 0 : INF;
  int top = 0;  // the ring row of row 0
  for (int q0 = 0; q0 < c.B; q0 += CH1) {
    __syncthreads();  // the last chunk's edges are read
    for (int k = j; k < CH1; k += K) {
      const Edges e = edges<true, K>(c, plane, data, cw, s,
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
// ---- combine: one CTA per shard -------------------------------------------
template <int K, int NST>
__global__ void combine(int n_b, const int32_t* T, int32_t* bounds,
                        int32_t* cost0) {
  extern __shared__ int4 smem4[];
  constexpr int TS = tsize(K);
  int* buf = reinterpret_cast<int*>(smem4);
  int* v = buf + NST * TS;
  const int s = blockIdx.x, tid = threadIdx.x;
  const int32_t* Ts = T + (int64_t)s * n_b * TS;
  auto fetch = [&](int t) {  // the t-th block from the right
    if (t < n_b) {
      const int4* src = reinterpret_cast<const int4*>(
          Ts + (int64_t)(n_b - 1 - t) * TS);
      int4* dst = reinterpret_cast<int4*>(buf + (t % NST) * TS);
      for (int x = tid; x < TS / 4; x += blockDim.x)
        __pipeline_memcpy_async(dst + x, src + x, 16);
    }
    __pipeline_commit();
  };
  for (int t = 0; t < NST - 1; t++) fetch(t);
  if (tid < K) v[tid] = 0;
  for (int t = 0; t < n_b; t++) {
    fetch(t + NST - 1);
    __pipeline_wait_prior(NST - 1);
    __syncthreads();
    const int* Tb = buf + (t % NST) * TS;
    int nv = INF;
    if (tid < K) {
      bounds[((int64_t)s * n_b + n_b - 1 - t) * K + tid] = v[tid];
      for (int jj = 0; jj < K; jj++) nv = min(nv, Tb[jj * K + tid] + v[jj]);
    }
    __syncthreads();
    if (tid < K) v[tid] = nv;
  }
  __syncthreads();
  if (tid == 0) cost0[s] = v[0];
}

// ---- pass 2, registers (X3): one thread per block --------------------------
template <int K, bool EXT, typename Choice>
__global__ void pass2_regs(Cfg c, const int32_t* plane, const uint8_t* data,
                           const int32_t* cw, const int32_t* npos,
                           const int32_t* bounds, Choice* choice,
                           int32_t* bad) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= c.S * c.n_b) return;
  const int s = blk / c.n_b, pend = (blk % c.n_b + 1) * c.B;
  const int np = npos[s];
  int wt[K + 1];
#pragma unroll
  for (int a = 0; a <= K; a++) wt[a] = match_bits<EXT>(c, a);
  int r[K];
#pragma unroll
  for (int i = 0; i < K; i++) r[i] = bounds[(int64_t)blk * K + i];
  bool flag = false;
  Choice* out = choice + (int64_t)s * c.NP;
  for (int q = 0; q < c.B; q += K) {
#pragma unroll
    for (int u = 0; u < K; u++) {
      const int p = pend - 1 - q - u;
      const Edges e = edges<EXT, K>(c, plane, data, cw, s, p, np);
      int best = min(r[(K - u) % K] + e.w0, INF), ch = 1;
#pragma unroll
      for (int a = 2; a <= K; a++) {
        const int x = min(r[(a - 1 - u + K) % K] + wt[a], INF);
        if (a <= e.hi && x < best) {
          best = x;
          ch = a;
        }
      }
      flag |= e.count && best >= INF;
      out[p] = (Choice)ch;
      r[K - 1 - u] = best;
    }
  }
  if (flag) atomicOr(bad + s, 1);
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
    for (int x = tid; x < nr; x += blockDim.x)
      bounds[((int64_t)s * n_b + n_b - 1 - t) * K + i0 + x] = cur[i0 + x];
    const int nxt = (t + 1) & 1;
    for (int r = warp; r < nr; r += blockDim.x >> 5) {
      int nv = INF;
      for (int jj = lane; jj < K; jj += 32)
        nv = min(nv, Tb[r * K + jj] + cur[jj]);
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
  if (rank == 0 && tid == 0) cost0[s] = v[(n_b & 1) * K];
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
  for (int a = lane; a <= K; a += 32) wx[a] = match_bits<true>(c, a);
  int wb[12];
#pragma unroll
  for (int b = 0; b < 12; b++) wb[b] = match_bits<true>(c, MINP + b);
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

template <int K, int NST>
int run_combine(const Cfg& c, int threads, const int32_t* T,
                int32_t* bounds, int32_t* cost0, cudaStream_t st) {
  const size_t smem = ((size_t)NST * tsize(K) + K) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      combine<K, NST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  combine<K, NST><<<c.S, threads, smem, st>>>(c.n_b, T, bounds, cost0);
  return (int)cudaGetLastError();
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

}  // namespace

// X3.  flen (S, NP) int32, data (S, NP) uint8, npos (S,); out: choice (S,
// NP) int32, cost0 (S,), bad (S,) int32 (zeroed by the caller); scratch: T
// (S * NP / B * 256) and bounds (S * NP / B * 16) int32.  B divides NP and
// is a multiple of 16.
extern "C" int tpt_opt_v1_choice(const void* flen, const void* data,
                                 const void* npos, void* choice, void* cost0,
                                 void* bad, void* T, void* bounds, int S,
                                 int NP, int B, int window, int literal,
                                 void* stream) {
  constexpr int K = 16;
  const Cfg c = make_cfg(S, NP, B, window, literal);
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = S * c.n_b;
  pass1_regs<K, false><<<(nblk + 7) / 8, 8 * K, 0, st>>>(
      c, (const int32_t*)flen, (const uint8_t*)data, nullptr,
      (const int32_t*)npos, (int32_t*)T);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int rc = run_combine<K, 8>(c, 32, (const int32_t*)T, (int32_t*)bounds,
                             (int32_t*)cost0, st);
  if (rc != 0) return rc;
  pass2_regs<K, false, int32_t><<<(nblk + 63) / 64, 64, 0, st>>>(
      c, (const int32_t*)flen, (const uint8_t*)data, nullptr,
      (const int32_t*)npos, (const int32_t*)bounds, (int32_t*)choice,
      (int32_t*)bad);
  return (int)cudaGetLastError();
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
