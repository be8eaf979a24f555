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
// What bounds it on this card: the token chain (each token's start is the
// previous start plus its bit length, one dependent shared-memory load a
// token), not bytes and not operations: a shard is one chain, so the kernel
// uses one SM a shard.  The first port also did every token's ring and
// output bytes on that chain, one byte at a time.
//
// Design: one block of two warps per shard, and nothing on the chain but
// the chain.
//   - Warp 0, lane 0 (the chain): hops c += delta over parse words that the
//     Tensor Memory Accelerator stages in shared memory, 4 tiles of 16 KiB in
//     flight, issued by the same lane with one mbarrier a tile, so no block
//     barrier falls in the walk.  It loads the next token's word before it
//     books the current token, so the load's latency overlaps the
//     bookkeeping.  Per token it keeps only what the chain needs (the output
//     offset, the ring head, the errors, the FLUSH state) and pushes an
//     8-byte record (kind, cnt, idx, ring head, ring bytes written) into a
//     shared-memory queue; a double FLUSH pushes a reset record.
//   - Warp 1 (the commit): drains the queue in batches of up to 32 records,
//     one record a lane.  Prefix sums give each token's output offset and
//     ring offset.  A batch ends before the first token whose source may
//     hold a byte written earlier in the batch (a match range that meets the
//     batch's ring writes so far, an RLE after any ring write), before a
//     reset, before its ring writes would pass W bytes (no ring byte is
//     written twice in a batch), and after a token that writes fewer ring
//     bytes than output bytes (an RLE of more than 8, a token that reaches
//     the ring end), so the batch's ring bytes are a prefix of its output.
//     Phase 1: the batch's output bytes (literal, ring source, byte behind
//     the head) from the ring as it was before the batch into an output
//     stage, lane j the first 8 bytes of token j, the whole warp the rest of
//     each longer token; that is the snapshot of every token at once.
//     Phase 2: that prefix of the stage to the ring at the batch's head, a
//     byte a lane.  A batch thus costs a few shared-memory latencies, not a
//     few a byte.
//   - The output stage (16 KiB, circular) goes to device memory in aligned
//     16-byte stores once 4 KiB are pending, and at the end up to the next
//     16-byte boundary with zeros past out_len.
// Shared memory: the tiles (64 KiB), the queue (32 KiB), the stage
// (16 KiB) and the ring (up to 32 KiB at window 15), so every window uses
// this kernel.  NBP must be a multiple of 4 (the bulk copies move 16-byte
// units; the parse's NBP is a multiple of 512) and the parse words 16-byte
// aligned.  The TPU kernel's unified output-as-ring mode and SMEM output
// chunks answer the TPU's SMEM size and DMA rules and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;        // warp 0: the chain; warp 1: the commit
constexpr int TW = 4096;           // parse words per staged tile
constexpr int NST = 4;             // tiles in flight
constexpr int Q = 8192;            // queue words (a power of two)
constexpr int OS = 16384;          // output stage bytes (a power of two)
constexpr int FLUSH_AT = 4096;     // pending stage bytes that trigger a flush
constexpr int CTRL = 128;          // mbarriers and queue counters
constexpr int ERR_OOB = 2, ERR_OVERFLOW = 3;
constexpr int K_LIT = 0, K_MATCH = 1, K_RLE = 2, K_EXT = 3, K_FLUSH = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

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

// ring[0 .. W) = src[0 .. W), by `nthr` threads from thread `tid`
__device__ __forceinline__ void ring_fill(uint8_t* ring,
                                          const uint8_t* __restrict__ src,
                                          int W, int tid, int nthr) {
  if (((uintptr_t)src & 15) == 0) {  // W >= 256, a multiple of 16
    for (int i = tid * 16; i < W; i += nthr * 16)
      *reinterpret_cast<uint4*>(ring + i) =
          *reinterpret_cast<const uint4*>(src + i);
  } else {
    for (int i = tid; i < W; i += nthr) ring[i] = src[i];
  }
}

__global__ void __launch_bounds__(THREADS)
commit_decode_kernel(const int32_t* __restrict__ pk,
                     const uint8_t* __restrict__ dict_init,
                     const uint8_t* __restrict__ dict_reset,
                     uint8_t* __restrict__ out, int32_t* __restrict__ lens,
                     int32_t* __restrict__ errs, int NBP, int wbits,
                     int more, int max_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);              // [NST]
  volatile int* head_v = reinterpret_cast<volatile int*>(smem + 64);
  volatile int* tail_v = head_v + 1;  // records the commit has taken
  volatile int* fin_v = head_v + 2;   // the chain has published its last
  volatile int* stop_v = head_v + 3;  // the commit has met the walk's end
  int32_t* tiles = reinterpret_cast<int32_t*>(smem + CTRL);        // [NST][TW]
  int32_t* queue = tiles + NST * TW;                               // [Q]
  uint8_t* stage = reinterpret_cast<uint8_t*>(queue + Q);          // [OS]
  uint8_t* ring = stage + OS;                                      // [W]
  const int W = 1 << wbits;
  const int M = W - 1;
  const int s = blockIdx.x;
  const int32_t* row = pk + (size_t)s * NBP;
  uint8_t* o_row = out + (size_t)s * max_out;

  ring_fill(ring, dict_init, W, threadIdx.x, THREADS);
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *head_v = 0;
    *tail_v = 0;
    *fin_v = 0;
    *stop_v = 0;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // ---- the chain: push the word of every token start, nothing else ----
    const int n_tiles = (NBP + TW - 1) / TW;
    int issued = 0;
    for (; issued < n_tiles && issued < NST; ++issued)
      tile_load(tiles + issued * TW, row + (size_t)issued * TW,
                (uint32_t)min(TW, NBP - issued * TW) * 4, &bars[issued]);
    int k = 0, tend = 0, toff = 0, n = 0, pub = 0, c = 0;
    int32_t p = 0;  // the word at c
    if (n_tiles > 0) {
      mbar_wait(&bars[0], 0);
      tend = min(TW, NBP);
      p = tiles[0];
    }
    while (n_tiles > 0) {
      if (n - pub >= 32) {  // publish; wait for room for the next 40
        __threadfence_block();
        *head_v = pub = n;
        while (n + 40 - *tail_v > Q && !*stop_v) {
        }
        if (*stop_v) break;
      }
      if (c + 4 * 63 < tend) {
        // four hops inside the tile: no tile check, one end check; a word
        // with delta 0 repeats and the commit stops at its first copy
        int low = 63;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          queue[(n + u) & (Q - 1)] = p;
          const int delta = (p >> 11) & 63;
          low = min(low, delta);
          c += delta;
          p = tiles[c + toff];
        }
        n += 4;
        if (low == 0) break;
        continue;
      }
      queue[n++ & (Q - 1)] = p;  // one hop, across a tile edge or the end
      const int delta = (p >> 11) & 63;
      c += delta;
      if (delta == 0 || c >= NBP) break;
      if (c >= tend) {
        // tile k is read: its stage takes tile k + NST; go on in tile k + 1
        if (issued < n_tiles) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          const int st = issued % NST;
          tile_load(tiles + st * TW, row + (size_t)issued * TW,
                    (uint32_t)min(TW, NBP - issued * TW) * 4, &bars[st]);
          ++issued;
        }
        ++k;
        mbar_wait(&bars[k % NST], (uint32_t)(k / NST) & 1);
        tend = min(k * TW + TW, NBP);
        toff = (k % NST) * TW - k * TW;
      }
      p = tiles[c + toff];
    }
    for (int j = k + 1; j < issued; ++j)  // no copy may land after exit
      mbar_wait(&bars[j % NST], (uint32_t)(j / NST) & 1);
    __threadfence_block();
    *head_v = n;
    __threadfence_block();
    *fin_v = 1;
    return;
  }
  if (threadIdx.x < 32) return;

  // ---- the commit: book and copy the tokens, 32 records a batch ----
  const int lane = threadIdx.x & 31;
  const bool vec = (max_out & 15) == 0 && ((uintptr_t)o_row & 15) == 0;
  int done = 0, out_pos = 0, flushed = 0, head_pos = 0, lwf = 0, err = 0;

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

  for (;;) {
    int head = __shfl_sync(FULL, lane == 0 ? *head_v : 0, 0);
    if (head == done) {
      if (!__shfl_sync(FULL, lane == 0 ? *fin_v : 0, 0)) continue;
      head = __shfl_sync(FULL, lane == 0 ? *head_v : 0, 0);
      if (head == done) break;  // the chain ran to NBP
    }
    __threadfence_block();
    const int nrec = min(32, head - done);
    const bool real = lane < nrec;
    const int32_t w = real ? queue[(done + lane) & (Q - 1)] : 0;
    const bool end = real && ((w >> 11) & 63) == 0;  // incomplete: stop
    const bool live = real && !end;
    const int kind = w & 7;
    const bool fl = live && kind == K_FLUSH;
    const int cnt = live && !fl ? (w >> 3) & 0xFF : 0;
    const int idx = (w >> 17) & M;
    const int prev_fl = __shfl_up_sync(FULL, (int)fl, 1);
    const bool reset = fl && more && (lane == 0 ? lwf : prev_fl);
    if (__shfl_sync(FULL, (int)reset, 0)) {
      ring_fill(ring, dict_reset, W, lane, 32);  // double FLUSH
      __syncwarp();
      head_pos = 0;
      lwf = 1;
      done += 1;
      if (lane == 0) *tail_v = done;
      continue;
    }
    // ring bytes a token writes if it does not reach the ring end
    const bool clamp = kind == K_EXT || kind == K_RLE;
    const int a = !live || fl ? 0
                  : kind == K_LIT ? 1
                  : kind == K_RLE ? min(cnt, 8)
                                  : cnt;
    int oin = cnt, ain = a;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(FULL, oin, d);
      const int y = __shfl_up_sync(FULL, ain, d);
      if (lane >= d) {
        oin += x;
        ain += y;
      }
    }
    const int oex = oin - cnt, rex = ain - a;
    // exact up to the batch's first token that reaches the ring end
    const int pos = (head_pos + rex) & M;
    const int wr = live && clamp && pos + a >= W ? W - pos : a;
    // a token that writes fewer ring bytes than output bytes (one that
    // reaches the ring end, an RLE of more than 8) ends the batch, so the
    // batch's ring bytes are a prefix of its output
    const unsigned pmask = __ballot_sync(FULL, wr < cnt);
    // the walk stops at a trailing incomplete token or an error
    const bool is_m = kind == K_MATCH || kind == K_EXT;
    int e = live && !fl && is_m && idx + cnt > W ? ERR_OOB : 0;
    if (live && !fl && out_pos + oin > max_out) e = ERR_OVERFLOW;
    const unsigned smask = __ballot_sync(FULL, end || e != 0);
    // the batch ends before a token whose source may hold a byte written
    // earlier in the batch, [head_pos, head_pos + rex) mod W
    bool cut = !real || reset || rex + wr > W ||
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
      const int rb = ring[(pos - 1) & M];  // an RLE token's byte
      // phase 1: the batch's output bytes from the ring as it was before
      // the batch (loads first: the stage never aliases the ring); lane j
      // copies the first 8 bytes of token j, the warp the rest of each
      // longer token
      if (lane < kk) {
        uint8_t v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = kind == K_LIT   ? (uint8_t)idx
                 : kind == K_RLE ? (uint8_t)rb
                 : u < cnt       ? ring[idx + u]
                                 : 0;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (u < cnt) stage[(out_pos + oex + u) & (OS - 1)] = v[u];
      }
      for (unsigned lm = __ballot_sync(FULL, lane < kk && cnt > 8); lm;
           lm &= lm - 1) {
        const int j = __ffs(lm) - 1;
        const int kj = __shfl_sync(FULL, kind, j);
        const int ij = __shfl_sync(FULL, idx, j);
        const int cj = __shfl_sync(FULL, cnt, j);
        const int oj = __shfl_sync(FULL, out_pos + oex, j);
        const int bj = __shfl_sync(FULL, rb, j);
        for (int m = 8 + lane; m < cj; m += 32)
          stage[(oj + m) & (OS - 1)] =
              kj == K_RLE ? (uint8_t)bj : ring[ij + m];
      }
      __syncwarp();
      // phase 2: the batch's first nr output bytes to the ring at its head
      const int nr = __shfl_sync(FULL, rex + wr, kk - 1);
      for (int r = lane; r < nr; r += 32)
        ring[(head_pos + r) & M] = stage[(out_pos + r) & (OS - 1)];
      __syncwarp();
      out_pos += __shfl_sync(FULL, oin, kk - 1);
      head_pos = (__shfl_sync(FULL, pos + wr, kk - 1)) & M;
      lwf = __shfl_sync(FULL, (int)fl, kk - 1);
      done += kk;
      if (lane == 0) *tail_v = done;
      if (out_pos - flushed >= FLUSH_AT) flush(out_pos & ~15);
    }
    if (ks < 32 && kk == ks) {  // the walk ends here
      err = __shfl_sync(FULL, e, ks);
      if (lane == 0) *stop_v = 1;
      break;
    }
  }
  // the last bytes, zero-padded to a 16-byte boundary
  const int last = vec ? (out_pos + 15) & ~15 : out_pos;
  for (int o = out_pos + lane; o < last; o += 32) stage[o & (OS - 1)] = 0;
  __syncwarp();
  flush(last);
  if (lane == 0) {
    lens[s] = out_pos;
    errs[s] = err;
  }
}

}  // namespace

extern "C" int tpt_commit_decode(const void* pk, const void* dict_init,
                                 const void* dict_reset, void* out,
                                 void* lens, void* errs, int S, int NBP,
                                 int wbits, int more, int max_out,
                                 void* stream) {
  if (NBP % 4 != 0 || ((uintptr_t)pk & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = CTRL + (size_t)NST * TW * 4 + (size_t)Q * 4 + OS +
                      ((size_t)1 << wbits);
  cudaError_t e = cudaFuncSetAttribute(
      commit_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  commit_decode_kernel<<<S, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pk, (const uint8_t*)dict_init,
      (const uint8_t*)dict_reset, (uint8_t*)out, (int32_t*)lens,
      (int32_t*)errs, NBP, wbits, more, max_out);
  return (int)cudaGetLastError();
}
