// Kernel B4: decode commit of parsed Tamp streams.
//
// Replaces the TPU kernel tamp_tpu/ops/decode_commit_pallas.py::_kernel (via
// commit_decode_batch), in its separate-ring form for every stream.  Per
// shard, a serial walk over the per-bit parse words
// pk[b] = kind(3) | cnt(8) << 3 | delta(6) << 11 | idx << 17 (delta = the
// token's bit length, 0 for a trailing incomplete token), from bit 0, that
// commits each token against a W-byte window ring:
//   - literal: one byte to the output and the ring;
//   - match: cnt bytes read from ring[idx ..] before the token writes
//     anything (snapshot), all written to the output and the ring with wrap;
//   - extended match: as a match, but the ring write stops at the ring end;
//   - RLE: cnt copies of the byte behind the head to the output, at most 8
//     to the ring, never wrapping;
//   - FLUSH: nothing; a second FLUSH in a row on a `more` stream resets the
//     ring to dict_reset and the head to 0.
// Errors end the walk: ERR_OOB (a match reads past the window), ERR_OVERFLOW
// (the output would pass max_out; checked after OOB and wins over it).  No
// token from the first error on writes anything.  The output past out_len
// stays zero (the wrapper zero-fills it).
//
// What bounds it on this card.  Two serial chains a shard: the token chain
// (each token's start is the previous start plus its bit length, one
// dependent load a token) and the ring (each batch of tokens reads bytes
// the batches before it wrote).  The first is only ordering: the next start
// depends on the word at the current one alone, so c -> c + delta is a
// function on bit positions and resolves tile-parallel, as B8 resolves its
// chase.  The second is a warp's, paced by the latency of its dependent
// instructions (~100 a batch of up to 32 tokens) and by the shared-memory
// pipe, not by bytes.
//
// Design: four launches on the caller's stream.
//   1-3. commit_decode_kernel_maps, _entries, _pack: the lane front of
//      exit_maps.cuh over tiles of ct parse words (NBP / 64, a power of two
//      in [CT_MIN, LANE_TILE]: a lane's walk is a tile long, so a small
//      plane takes small tiles).  A hop is delta bits (<= 63), and delta 0
//      (the walk's end mark) stops the chain.  A map is (the exit code |
//      tokens << 8, the sum of their steps: output bytes + ring bytes <<
//      16).  The pack writes each token's record, its word and the running
//      sum before it, in order, into the shard's row of recs (S, cap), then
//      the stop word where the chain ends on one; the entries put a zero at
//      T for a chain that runs to NBP.
//   4. commit_decode_kernel (the commit): a cluster of two CTAs a shard, a
//      warp each, on two SMs, so that neither takes the other's
//      shared-memory pipe.  Each stages the records with the Tensor Memory
//      Accelerator, NST tiles of TW in flight, one mbarrier a tile.
//      - The booking CTA cuts the records into batches of up to 32, one a
//        lane, T known from the start.  A record's sum less the batch's
//        first gives its output and ring offsets in the batch (each < 2^16,
//        so the packed difference holds both): no prefix scan.  A batch
//        ends before the first token whose source may hold a byte written
//        earlier in the batch (a match range that meets the batch's ring
//        writes so far, an RLE after any ring write), before a reset,
//        before its ring writes would pass W bytes (no ring byte is written
//        twice in a batch), and after a token that writes fewer ring bytes
//        than output bytes (an RLE of more than 8, a token that reaches the
//        ring end), so the batch's ring bytes are a prefix of its output;
//        errors end the walk.  It hands each batch (its size or a reset or
//        the end, its ring bytes, its head) to the copy CTA in groups of GS,
//        a descriptor a lane in one st.async into the copy CTA's slots,
//        which completes that group's mbarrier there; the copy CTA arrives
//        on the booking CTA's mbarrier of a group once it has taken it.
//      - The copy CTA, for each batch: phase 1, the batch's output bytes
//        (literal, ring source, byte behind the head) from the ring as it
//        was before the batch into an output stage, lane j the first
//        LANE_BYTES bytes of token j, the warp the rest of each longer
//        token, every lane's loads before a barrier and its stores after
//        it (the snapshot of every token at once); phase 2, that prefix of
//        the stage to the ring at the batch's head.  The output stage (16
//        KiB, circular) goes to device memory in aligned 16-byte stores
//        once 4 KiB are pending, and at the end up to the next 16-byte
//        boundary with zeros past out_len.
// Every launch's name holds "commit_decode_kernel", the profiler's key for
// B4.  The commit's shared memory: the tiles (64 KiB), the stage (16 KiB)
// and the ring (up to 32 KiB at window 15, and a pad the lanes' loads may
// reach), so every window uses this kernel.  NBP must be a multiple of 4
// (16-byte staging; the parse's NBP is a multiple of 512) and the parse
// words 16-byte aligned.  The compact plane has cap slots a shard, an even
// number: the caller's floor on a token's bits (1 + literal for a parse:
// a literal; a match takes 2 + window bits, a FLUSH 9) bounds the chain to
// NBP / floor + 1 tokens and its stop word.  A shard whose chain holds cap
// tokens or more (a plane below its floor) is refused with ERR_INVALID and
// decodes nothing; the pack writes no slot past cap.  The wrapper allocates
// the workspace (the records, the maps, the entries, the counts).
// The TPU kernel's unified output-as-ring mode and SMEM output chunks
// answer the TPU's SMEM size and DMA rules and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "exit_maps.cuh"

namespace {

constexpr int CT_MIN = 512;        // parse words a front tile, at least
constexpr int THREADS = 32;        // the commit: a warp a CTA, two a shard
constexpr int GS = 32;             // batch descriptors a group
constexpr int NG = 4;              // groups in flight
constexpr int QK = NG * GS;        // batch descriptor slots
constexpr int Q_RESET = 63, Q_END = 62;  // descriptor codes past a batch
constexpr int TW = 2048;           // records (word, sum) a staged tile
constexpr int NST = 4;             // tiles in flight
constexpr int OS = 16384;          // output stage bytes (a power of two)
constexpr int FLUSH_AT = 4096;     // pending stage bytes that trigger a flush
constexpr int CTRL = 384 + QK * 8;  // mbarriers, descriptor slots
static_assert((NST + 2 * NG) * 8 <= 384, "the mbarriers pass their room");
constexpr int LANE_BYTES = 12;     // bytes of its token a lane copies
constexpr int RING_PAD = 16;       // ring bytes past W that lanes may read
constexpr int ERR_INVALID = 1, ERR_OOB = 2, ERR_OVERFLOW = 3;
constexpr int K_LIT = 0, K_MATCH = 1, K_RLE = 2, K_EXT = 3, K_FLUSH = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int delta_of(int32_t p) { return (p >> 11) & 63; }

// a token's output bytes + its ring bytes (before the ring end clamps them)
// << 16: the step of the running sum that the front keeps beside each word
__device__ __forceinline__ uint32_t sum_step(int32_t p) {
  const int kind = p & 7, cnt = (p >> 3) & 0xFF;
  if (kind == K_FLUSH) return 0;
  const int a = kind == K_LIT ? 1 : kind == K_RLE ? min(cnt, 8) : cnt;
  return (uint32_t)cnt + ((uint32_t)a << 16);
}

__global__ void __launch_bounds__(LANE_MAP_THREADS)
commit_decode_kernel_maps(const int32_t* __restrict__ pk,
                          int2* __restrict__ maps, int NBP, int n_tiles,
                          int ct) {
  int cnt = 0;  // the tokens on the way, and the sum of their steps
  uint32_t sum = 0;
  lane_maps(
      pk, maps, NBP, n_tiles, ct,
      [&](int32_t p, int c) {
        if (delta_of(p) == 0) return -1;  // the walk's end mark
        ++cnt;
        sum += sum_step(p);
        return c + delta_of(p);
      },
      [&](int x) { return make_int2(x | cnt << 8, (int)sum); });
}

__global__ void __launch_bounds__(LANE_ENT_THREADS)
commit_decode_kernel_entries(const int2* __restrict__ maps,
                             int32_t* __restrict__ ent,
                             int32_t* __restrict__ tok,
                             int2* __restrict__ recs, int cap,
                             int n_tiles) {
  const int s = blockIdx.x;
  // each visited tile's entry bit, token offset and running sum there
  int32_t* e_row = ent + (size_t)s * 3 * n_tiles;
  int total = 0;
  uint32_t sum = 0;
  const int visited = walk_entries<LANE_ENT_THREADS, SPAN>(
      maps + (size_t)s * n_tiles * SPAN, n_tiles, 0,
      [&](int k, int e) {
        e_row[k] = e;
        e_row[n_tiles + k] = total;
        e_row[2 * n_tiles + k] = (int)sum;
      },
      [&](int, int2 v) {
        total += v.x >> 8;
        sum += (uint32_t)v.y;
        return (v.x & 255) >= X_STOP ? -1 : v.x & 255;
      });
  if (threadIdx.x == 0) {
    tok[2 * s] = total;
    tok[2 * s + 1] = visited;
    // the end of a chain that runs to NBP; the pack overwrites it with the
    // stop word where the chain ends on one
    if (total < cap) recs[(size_t)s * cap + total] = make_int2(0, (int)sum);
  }
}

__global__ void __launch_bounds__(LANE_PACK_THREADS)
commit_decode_kernel_pack(const int32_t* __restrict__ pk,
                          const int32_t* __restrict__ ent,
                          const int32_t* __restrict__ tok,
                          int2* __restrict__ recs, int NBP, int cap,
                          int n_tiles, int ct) {
  const ShardBlock p = shard_block(n_tiles);
  if (p.b >= tok[2 * p.s + 1]) return;  // not visited
  const int32_t* e_row = ent + (size_t)p.s * 3 * n_tiles;
  int2* r_row = recs + (size_t)p.s * cap;
  int o = e_row[n_tiles + p.b];
  uint32_t sum = (uint32_t)e_row[2 * n_tiles + p.b];
  const int base = p.b * ct;
  // each token's record (word, running sum before it), the stop word too
  pack_tile(pk + (size_t)p.s * NBP, base, min(base + ct, NBP), e_row[p.b],
            [&](int32_t w, int c) {
              if (o >= cap) return -1;
              r_row[o++] = make_int2(w, (int)sum);
              if (delta_of(w) == 0) return -1;
              sum += sum_step(w);
              return c + delta_of(w);
            });
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t ok = 0;
  while (!ok) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// one bulk copy of `bytes` (a multiple of 16) from device memory into
// shared memory, completing on `bar`
__device__ __forceinline__ void tile_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ring[0 .. W) = src[0 .. W), by the warp
__device__ __forceinline__ void ring_fill(uint8_t* ring,
                                          const uint8_t* __restrict__ src,
                                          int W, int lane) {
  if (((uintptr_t)src & 15) == 0) {  // W >= 256, a multiple of 16
    for (int i = lane * 16; i < W; i += 32 * 16)
      *reinterpret_cast<uint4*>(ring + i) =
          *reinterpret_cast<const uint4*>(src + i);
  } else {
    for (int i = lane; i < W; i += 32) ring[i] = src[i];
  }
}

// wait for phase `parity` of an mbarrier that the other CTA of the cluster
// completes (its bytes or its arrivals); trap (a launch error, not a hang)
// if it has not in ~2^31 cycles
__device__ __forceinline__ void peer_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok = 0;
  const long long t0 = clock64();
  while (!ok) {
    if (clock64() - t0 > (1ll << 31)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// the address of `p` (in this CTA's shared memory) in the CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a = smem_addr(p);
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;\n" : "+r"(a) : "r"(rank));
  return a;
}

__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS)
commit_decode_kernel(const int2* __restrict__ recs,
                     const int32_t* __restrict__ tok,
                     const uint8_t* __restrict__ dict_init,
                     const uint8_t* __restrict__ dict_reset,
                     uint8_t* __restrict__ out, int32_t* __restrict__ lens,
                     int32_t* __restrict__ errs, int cap, int wbits,
                     int more, int max_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);              // [NST]
  // the copy CTA's: each group of 32 batch descriptors arrives there by
  // st.async and completes its mbarrier; the booking CTA's: the copy CTA
  // arrives on one when it has taken a group, so its slots are free
  uint64_t* full = bars + NST;                                     // [NG]
  uint64_t* empty = full + NG;                                     // [NG]
  int2* kq = reinterpret_cast<int2*>(smem + 384);                  // [QK]
  int2* tiles = reinterpret_cast<int2*>(smem + CTRL);              // [NST][TW]
  uint8_t* stage = reinterpret_cast<uint8_t*>(tiles + NST * TW);   // [OS]
  uint8_t* ring = stage + OS;                            // [W + RING_PAD]
  const int W = 1 << wbits;
  const int M = W - 1;
  const ShardBlock sb = shard_block(2);
  const int s = sb.s;
  const int booking = sb.b == 0;  // the cluster's rank 0
  const int lane = threadIdx.x;
  // the shard's tokens, all complete; a chain past its slots is refused
  const bool refused = tok[2 * s] >= cap;
  const int n = refused ? 0 : tok[2 * s];
  const int2* r_row = recs + (size_t)s * cap;
  const int n_tw = (n + TW - 1) / TW;
  const int n2 = (n + 1) & ~1;  // <= cap: whole 16-byte units
  auto issue = [&](int j) {     // lane 0: stage tile j of the records
    tile_load(tiles + (j % NST) * TW, r_row + (size_t)j * TW,
              (uint32_t)min(TW, n2 - j * TW) * 8, &bars[j % NST]);
  };

  if (!booking) ring_fill(ring, dict_init, W, lane);
  int issued = min(n_tw, NST);
  if (lane == 0) {
    for (int i = 0; i < NST; ++i) mbar_init(&bars[i]);
    for (int i = 0; i < NG; ++i) {
      mbar_init(&full[i]);
      mbar_init(&empty[i]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (!booking)
      for (int i = 0; i < NG; ++i) expect_bytes(&full[i], GS * 8);
    for (int j = 0; j < issued; ++j) issue(j);
  }
  __syncwarp();
  // every barrier of both CTAs is set up before either touches the other
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");

  int done = 0, ready = 0, out_pos = 0;
  // tiles wholly behind `done` are read: their stages take the next ones
  auto stage_ahead = [&]() {
    for (; issued < n_tw && issued - NST < done / TW; ++issued) {
      if (lane == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(issued);
      }
      __syncwarp();
    }
  };
  auto wait_tiles = [&](int last) {  // tiles up to `last` have landed
    for (; ready <= last; ++ready)
      mbar_wait(&bars[ready % NST], (uint32_t)(ready / NST) & 1);
  };

  if (booking) {
    // ---- the booking CTA: cut the records into batches, in order ----
    int head_pos = 0, lwf = 0, err = 0, q = 0;
    int2 mine = make_int2(0, 0);  // lane j < GS: the open group's j-th
    int2 rec = make_int2(0, 0);   // the batch's records, one a lane
    uint32_t base = 0;            // the running sum at the batch's first
    bool have = false;  // rec and base hold them (read during the last one)
    // group g's GS descriptors, one a lane, into the copy CTA's slots of
    // group g % NG once it has taken group g - NG from them
    auto send = [&](int g) {
      if (g >= NG) peer_wait(&empty[g % NG], (uint32_t)(g / NG - 1) & 1);
      const uint32_t dst = peer_addr(&kq[(g % NG) * GS + lane % GS], 1);
      const uint32_t bar = peer_addr(&full[g % NG], 1);
      asm volatile(
          "{\n .reg .pred p;\n setp.lt.s32 p, %4, %5;\n"
          " @p st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 "
          "[%0], {%1, %2}, [%3];\n}\n" ::"r"(dst),
          "r"(mine.x), "r"(mine.y), "r"(bar), "r"(lane), "n"(GS)
          : "memory");
    };
    auto publish = [&](int kk, int nr) {  // batch q: kk (or a code), nr
      if (lane == q % GS) mine = make_int2(kk | nr << 6, head_pos);
      if (++q % GS == 0) send(q / GS - 1);
    };
    while (done < n) {
      stage_ahead();
      const int nrec = min(32, n - done);
      const bool live = lane < nrec;
      if (!have) {
        wait_tiles((done + nrec - 1) / TW);
        if (live) rec = tiles[(done + lane) & (NST * TW - 1)];
        base = (uint32_t)tiles[done & (NST * TW - 1)].y;
      }
      have = false;
      const int32_t w = live ? rec.x : 0;
      const int kind = w & 7;
      const bool fl = live && kind == K_FLUSH;
      const int cnt = live && !fl ? (w >> 3) & 0xFF : 0;
      const int idx = (w >> 17) & M;
      const unsigned flm = __ballot_sync(FULL, fl);
      const bool reset =
          fl && more && (lane == 0 ? lwf : (flm >> (lane - 1)) & 1);
      if (__ballot_sync(FULL, reset) & 1) {  // double FLUSH
        publish(Q_RESET, 0);
        head_pos = 0;
        lwf = 1;
        done += 1;
        continue;
      }
      // ring bytes a token writes if it does not reach the ring end
      const bool clamp = kind == K_EXT || kind == K_RLE;
      const int a0 = kind == K_LIT ? 1 : kind == K_RLE ? min(cnt, 8) : cnt;
      const int a = live && !fl ? a0 : 0;
      // each token's output and ring offsets in the batch, from the running
      // sum of (output bytes + ring bytes << 16) that the front keeps
      // beside its word: a batch's differences are < 2^16 each
      const uint32_t d = (uint32_t)rec.y - base;
      const int oex = live ? (int)(d & 0xFFFF) : 0;
      const int rex = live ? (int)(d >> 16) : 0;
      const int oin = oex + cnt;
      // exact up to the batch's first token that reaches the ring end
      const int pos = (head_pos + rex) & M;
      const int wr = live && clamp && pos + a >= W ? W - pos : a;
      // a token that writes fewer ring bytes than output bytes (one that
      // reaches the ring end, an RLE of more than 8) ends the batch, so the
      // batch's ring bytes are a prefix of its output
      const unsigned pmask = __ballot_sync(FULL, wr < cnt);
      // the walk stops at an error
      const bool is_m = kind == K_MATCH || kind == K_EXT;
      int e = live && !fl && is_m && idx + cnt > W ? ERR_OOB : 0;
      if (live && !fl && out_pos + oin > max_out) e = ERR_OVERFLOW;
      const unsigned smask = __ballot_sync(FULL, e != 0);
      // the batch ends before a token whose source may hold a byte written
      // earlier in the batch, [head_pos, head_pos + rex) mod W
      bool cut = !live || reset || rex + wr > W ||
                 (pmask & ((1u << lane) - 1)) != 0;
      if (is_m)
        cut |= rex > 0 && (((idx - head_pos) & M) < rex ||
                           ((head_pos - idx) & M) < cnt);
      else if (kind == K_RLE)
        cut |= rex > 0;
      const unsigned cmask = __ballot_sync(FULL, cut) & ~1u;
      const int kc = cmask ? __ffs(cmask) - 1 : 32;
      const int ks = smask ? __ffs(smask) - 1 : 32;
      const int kk = min(kc, ks);
      if (kk > 0) {
        // the next batch's records, read while this one is handed over,
        // where their tiles have landed
        const int nd = done + kk, nn = min(32, n - nd);
        have = nd < n && (nd + nn - 1) / TW < ready;
        int2 rn = make_int2(0, 0);
        uint32_t bn = 0;
        if (have) {
          if (lane < nn) rn = tiles[(nd + lane) & (NST * TW - 1)];
          bn = (uint32_t)tiles[nd & (NST * TW - 1)].y;
        }
        const int nr = __shfl_sync(FULL, rex + wr, kk - 1);
        const int ob = __shfl_sync(FULL, oin, kk - 1);
        const int hp = __shfl_sync(FULL, pos + wr, kk - 1) & M;
        publish(kk, nr);
        out_pos += ob;
        head_pos = hp;
        lwf = (flm >> (kk - 1)) & 1;
        done += kk;
        rec = rn;
        base = bn;
      }
      if (ks < 32 && kk == ks) {  // the walk ends here
        err = __shfl_sync(FULL, e, ks);
        break;
      }
    }
    publish(Q_END, 0);
    if (q % GS) send(q / GS);  // the last, open group
    wait_tiles(issued - 1);    // no copy may land after exit
    if (lane == 0) errs[s] = refused ? ERR_INVALID : err;
  } else {
    // ---- the copy CTA: each batch's bytes to the stage and the ring ----
    uint8_t* o_row = out + (size_t)s * max_out;
    const bool vec = (max_out & 15) == 0 && ((uintptr_t)o_row & 15) == 0;
    int flushed = 0;
    auto flush = [&](int end) {  // stage bytes [flushed, end) to the row
      if (vec) {
        for (int o = flushed + 16 * lane; o < end; o += 512)
          *reinterpret_cast<uint4*>(o_row + o) =
              *reinterpret_cast<const uint4*>(stage + (o & (OS - 1)));
      } else {
        for (int o = flushed + lane; o < end; o += 32)
          o_row[o] = stage[o & (OS - 1)];
      }
      flushed = end;
      __syncwarp();
    };
    for (int q = 0;; ++q) {
      const int g = q / GS;
      if (q % GS == 0) peer_wait(&full[g % NG], (uint32_t)(g / NG) & 1);
      const int2 dq = kq[q & (QK - 1)];
      const int kk = dq.x & 63, nr = dq.x >> 6, head = dq.y;
      if (out_pos - flushed >= FLUSH_AT) flush(out_pos & ~15);
      if (kk == Q_END) break;
      if (kk == Q_RESET) {
        ring_fill(ring, dict_reset, W, lane);
        __syncwarp();
        done += 1;
      } else {
        stage_ahead();
        wait_tiles((done + kk - 1) / TW);
        const bool live = lane < kk;
        const int2 rec = tiles[(done + lane) & (NST * TW - 1)];
        const uint32_t base = (uint32_t)tiles[done & (NST * TW - 1)].y;
        const int32_t w = rec.x;
        const int kind = w & 7;
        const int cnt = live && kind != K_FLUSH ? (w >> 3) & 0xFF : 0;
        const int idx = (w >> 17) & M;
        const uint32_t d = (uint32_t)rec.y - base;
        const int oex = (int)(d & 0xFFFF), rex = (int)(d >> 16);
        const int pos = (head + rex) & M;
        const int rb = ring[(pos - 1) & M];  // an RLE token's byte
        // phase 1: the batch's output bytes from the ring as it was before
        // the batch into the stage; lane j the first LANE_BYTES bytes of
        // token j, the warp the rest of each longer token.  The loads are
        // unconditional (the ring's pad holds the reads past its end) and
        // all come before the barrier, the stores after it: a load under a
        // branch, or after a store the compiler cannot tell from the ring,
        // waits out the latency of the one before
        const int cl = min(cnt, LANE_BYTES);
        const bool is_src = kind == K_MATCH || kind == K_EXT;
        const uint8_t fill = kind == K_LIT ? (uint8_t)idx : (uint8_t)rb;
        uint8_t v[LANE_BYTES];
#pragma unroll
        for (int u = 0; u < LANE_BYTES; ++u) {
          const uint8_t x = ring[idx + u];
          v[u] = is_src ? x : fill;
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < LANE_BYTES; ++u)
          if (u < cl) stage[(out_pos + oex + u) & (OS - 1)] = v[u];
        for (unsigned lm = __ballot_sync(FULL, cnt > LANE_BYTES); lm;
             lm &= lm - 1) {
          const int j = __ffs(lm) - 1;
          const int kj = __shfl_sync(FULL, kind, j);
          const int ij = __shfl_sync(FULL, idx, j);
          const int cj = __shfl_sync(FULL, cnt, j);
          const int oj = __shfl_sync(FULL, out_pos + oex, j);
          const int bj = __shfl_sync(FULL, rb, j);
          for (int m = LANE_BYTES + lane; m < cj; m += 32)
            stage[(oj + m) & (OS - 1)] =
                kj == K_RLE ? (uint8_t)bj : ring[ij + m];
        }
        __syncwarp();
        // phase 2: the batch's first nr output bytes to the ring at its
        // head, 96 a round, loads before stores
        for (int r0 = 0; r0 < nr; r0 += 96) {
          uint8_t b[3];
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            const int r = r0 + lane + 32 * u;
            b[u] = r < nr ? stage[(out_pos + r) & (OS - 1)] : 0;
          }
          __syncwarp();
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            const int r = r0 + lane + 32 * u;
            if (r < nr) ring[(head + r) & M] = b[u];
          }
        }
        __syncwarp();
        out_pos += __shfl_sync(FULL, oex + cnt, kk - 1);
        done += kk;
      }
      if (q % GS == GS - 1 && lane == 0) {
        // group g is taken: its slots wait for group g + NG
        expect_bytes(&full[g % NG], GS * 8);
        asm volatile(
            "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
            ::"r"(peer_addr(&empty[g % NG], 0))
            : "memory");
      }
    }
    wait_tiles(issued - 1);  // no copy may land after exit
    // the last bytes, zero-padded to a 16-byte boundary
    const int last = vec ? (out_pos + 15) & ~15 : out_pos;
    for (int o = out_pos + lane; o < last; o += 32) stage[o & (OS - 1)] = 0;
    __syncwarp();
    flush(last);
    if (lane == 0) lens[s] = out_pos;
  }
  // neither CTA leaves while the other may still reach its memory
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

}  // namespace

// ct: parse words a front tile, a power of two in [CT_MIN, LANE_TILE]; cap:
// the records' slots a shard, even; recs (S, cap) int2, maps (S, n_tiles,
// SPAN) int2, ent (S, 3, n_tiles) and tok (S, 2) int32 are the wrapper's
// workspace: the compact token records (word, running sum), each tile's
// exit maps, each visited tile's entry bit, token offset and running sum,
// and per shard (tokens, tiles visited)
extern "C" int tpt_commit_decode(const void* pk, const void* dict_init,
                                 const void* dict_reset, void* out,
                                 void* lens, void* errs, void* recs,
                                 void* maps, void* ent, void* tok, int S,
                                 int NBP, int cap, int ct, int wbits,
                                 int more, int max_out, void* stream) {
  if (NBP % 4 != 0 || ((uintptr_t)pk & 15) != 0 ||
      ((uintptr_t)recs & 15) != 0 || ct < CT_MIN || ct > LANE_TILE ||
      (ct & (ct - 1)) != 0 || cap < 2 || cap % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (NBP + ct - 1) / ct;
  cudaError_t e = launch_shards(commit_decode_kernel_maps, S, n_tiles,
                                LANE_MAP_THREADS, 0, st, pk, maps, NBP,
                                n_tiles, ct);
  if (e == cudaSuccess)
    e = launch_shards(commit_decode_kernel_entries, S, 1, LANE_ENT_THREADS, 0,
                      st, maps, ent, tok, recs, cap, n_tiles);
  if (e == cudaSuccess)
    e = launch_shards(commit_decode_kernel_pack, S, n_tiles,
                      LANE_PACK_THREADS, 0, st, pk, ent, tok, recs, NBP, cap,
                      n_tiles, ct);
  if (e != cudaSuccess) return (int)e;
  const size_t smem =
      CTRL + (size_t)NST * TW * 8 + OS + ((size_t)1 << wbits) + RING_PAD;
  e = cudaFuncSetAttribute(commit_decode_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_shards(commit_decode_kernel, S, 2, THREADS, smem, st,
                            recs, tok, dict_init, dict_reset, out, lens, errs,
                            cap, wbits, more, max_out);
}
