// Kernel X2: token-serial decode of Tamp payloads, one block per shard.
//
// Replaces the vmapped token-serial lax.while_loop of
// tamp_tpu/ops/decode_jax.py::_decode_batch (algorithm="serial").  Per
// shard, from the payload's first bit (the host strips the header):
//   - a 64-bit accumulator refilled 32 bits at a time (the payload's last
//     word with its valid bytes only); a token that the remaining bits
//     cannot complete ends the decode with no error (it is dropped, as the
//     reference decoders roll it back);
//   - literal: flag 1 + `literal` bits, to the output and the ring;
//   - flag 0 + Huffman symbol s1 (an 8-bit peek, zero-padded at the tail):
//     FLUSH drops bits % 8 (aligns the stream to a byte) and, on a `more`
//     stream, a second FLUSH in a row resets the ring to dict_reset and the
//     head to 0; in the extended format s1 = 12 is RLE (symbol s2, 4 trail
//     bits: count s2 << 4 + trail + 2 copies of the byte behind the head, at
//     most 8 of them to the ring, never wrapping) and s1 = 13 an extended
//     match (s2, 3 trail bits, window bits: size s2 << 3 + trail + minp + 12
//     at idx, the ring write stops at the ring end); otherwise a match of
//     s1 + minp bytes at the next window bits, written to the ring with
//     wrap.  A match's source bytes are read before it writes any.
//   - a match reading past the window is ERR_OOB and ends the decode, with
//     no byte of that token written;
//   - the decode stops before a token once max_out bytes are out (no
//     error); the token that crosses max_out writes its first bytes up to
//     max_out and all its ring bytes.
// Output: bytes (S, max_out) (the wrapper zero-fills), lengths (<= max_out)
// and error codes (S,).
//
// What bounds it on this card: the dependence chain of the parse (each
// token's first bit comes from the previous token's length), not bytes: a
// shard is one chain, so the kernel uses one SM a shard.
//
// Design: kernel B4's split (csrc/decode_commit.cu) for a decoder that
// parses for itself.  One block of two warps per shard.
//   - Warp 0, lane 0 (the parse lane) carries nothing but the chain.  It
//     stages the payload in shared memory with bulk asynchronous copies
//     (TMA, 4 tiles of 8 KiB in flight, one mbarrier a tile), refills 32
//     bits at a time from the staged tile into a left-aligned 64-bit
//     buffer (the remaining-bit count stays 8 * bytes read - bits used, so
//     FLUSH's bits % 8 is the plain version's), and keeps only the output
//     count (for max_out), the FLUSH state and the error.  While 33 bits
//     are held (a token's most) no token checks for its bits, and a
//     literal or a basic match (most tokens) is decoded without a branch
//     from a 512-entry token table of the next 9 bits (its bit count, its
//     record, where its field lies); FLUSH, RLE and extended matches take
//     a 256-entry peek table of (symbol, code length).  One branch a
//     token tests for the rare work (a refill, max_out, publishing the
//     queue, and, once fewer than 33 bits are left at the payload's end,
//     the next token's bit count against them).  Per token it pushes a
//     4-byte record (kind, cnt, idx or the literal byte) into a
//     shared-memory queue; a double FLUSH pushes a reset record; a single
//     FLUSH pushes nothing.
//   - Warp 1 (the x2 commit warp) drains the queue in batches of up to 32
//     records under B4's batch rules: prefix sums give each token's output
//     and ring offsets; a batch ends before a token whose source may hold
//     a byte written earlier in the batch, before a reset, before its ring
//     writes would pass W bytes, and after a token that writes fewer ring
//     bytes than output bytes, so the batch's ring bytes are a prefix of
//     its output.  Phase 1 copies the batch's output bytes from the ring as
//     it was before the batch into a circular output stage (the snapshot of
//     every token at once), phase 2 that prefix of the stage into the ring.
//     The stage goes to device memory in aligned 16-byte stores, cut at
//     max_out.  B4's own commit warp also finds the walk's end and its
//     errors in the parse words; here the parse lane decides those, so this
//     warp is B4's without its stop and error paths.
// Shared memory: the tiles (32 KiB), the queue (32 KiB), the stage (16 KiB),
// the two tables and the ring (up to 32 KiB at window 15), so every window
// uses this kernel.  Lp must be a multiple of 16 and the payloads 16-byte
// aligned (the bulk copies move 16-byte units; the wrapper pads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;    // warp 0: the parse lane; warp 1: the commit
constexpr int TB = 8192;       // payload bytes per staged tile
constexpr int NST = 4;         // tiles in flight
constexpr int Q = 8192;        // queue words (a power of two)
constexpr int OS = 16384;      // output stage bytes (a power of two)
constexpr int FLUSH_AT = 4096;  // pending stage bytes that trigger a flush
constexpr int CTRL = 128;      // mbarriers and queue counters
constexpr int ERR_OOB = 2;
constexpr int FLUSH_SYM = 14, RLE_SYM = 12, EXT_SYM = 13;
// record kinds: kind(3) | cnt(8) << 3 | idx or literal byte(15) << 11
constexpr int K_LIT = 0, K_MATCH = 1, K_RLE = 2, K_EXT = 3, K_RESET = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Huffman codes (flag bit excluded) and their lengths, symbols 0..14.
__constant__ uint8_t HCODE[15] = {0x00, 0x03, 0x08, 0x0B, 0x14, 0x24, 0x26,
                                  0x2B, 0x4B, 0x54, 0x94, 0x95, 0xAA, 0x27,
                                  0xAB};
__constant__ uint8_t HLEN[15] = {1, 2, 4, 4, 5, 6, 6, 6, 7, 7, 8, 8, 8, 6, 8};

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

// shared-memory word load and store at a 32-bit shared address: the parse
// lane computes its table, tile and queue addresses once, so no access in
// its loop recomputes the shared window's base
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// x, as a value the compiler keeps in a register (a kernel argument is
// otherwise reloaded from the constant bank in the loop)
__device__ __forceinline__ int reg(int x) {
  asm volatile("" : "+r"(x));
  return x;
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
serial_decode_kernel(const uint8_t* __restrict__ in,
                     const int32_t* __restrict__ nbytes, int Lp,
                     const uint8_t* __restrict__ dict_init,
                     const uint8_t* __restrict__ dict_reset,
                     uint8_t* __restrict__ out, int32_t* __restrict__ lens,
                     int32_t* __restrict__ errs, int wbits, int literal,
                     int extended, int more, int minp, int max_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);              // [NST]
  volatile int* head_v = reinterpret_cast<volatile int*>(smem + 64);
  volatile int* tail_v = head_v + 1;  // records the commit has taken
  volatile int* fin_v = head_v + 2;   // the parse has published its last
  volatile int* err_v = head_v + 3;   // the parse's error code
  uint8_t* tiles = smem + CTRL;                                    // [NST][TB]
  int32_t* queue = reinterpret_cast<int32_t*>(tiles + NST * TB);   // [Q]
  uint8_t* stage = reinterpret_cast<uint8_t*>(queue + Q);          // [OS]
  int32_t* tok = reinterpret_cast<int32_t*>(stage + OS);           // [512]
  uint8_t* peek = reinterpret_cast<uint8_t*>(tok + 512);           // [256]
  uint8_t* ring = peek + 256;                                      // [W]
  const int W = 1 << wbits;
  const int M = W - 1;
  const int s = blockIdx.x;
  uint8_t* o_row = out + (size_t)s * max_out;

  ring_fill(ring, dict_init, W, threadIdx.x, THREADS);
  for (int pk = threadIdx.x; pk < 256; pk += THREADS) {
    // symbol | code length << 4 of an 8-bit peek (the code is complete:
    // exactly one codeword prefixes any peek)
    int sy = 0;
    while ((pk >> (8 - HLEN[sy])) != HCODE[sy]) ++sy;
    peek[pk] = (uint8_t)(sy | HLEN[sy] << 4);
    // the token of the next 9 bits (flag, 8-bit peek): its bits, its
    // record's kind | cnt << 3, the bits before its field and the field's
    // width; FLUSH, RLE and extended matches are marked rare (bit 6)
    const int l1 = HLEN[sy];
    tok[256 + pk] = (1 + literal) | (K_LIT | 1 << 3) << 8 | 1 << 20 |
                    literal << 24;
    tok[pk] = sy == FLUSH_SYM || (extended && (sy == RLE_SYM ||
                                               sy == EXT_SYM))
                  ? 64 | 1 << 20 | 8 << 24
                  : (1 + l1 + wbits) | (K_MATCH | (sy + minp) << 3) << 8 |
                        (1 + l1) << 20 | wbits << 24;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *head_v = 0;
    *tail_v = 0;
    *fin_v = 0;
    *err_v = 0;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // ---- the parse lane: one record a token, nothing else ----
    const uint8_t* src = in + (size_t)s * Lp;
    const int n = nbytes[s];
    const int staged = (n + 15) & ~15;  // bytes the copies bring in
    const int n_tiles = (staged + TB - 1) / TB;
    int issued = 0;
    for (; issued < n_tiles && issued < NST; ++issued)
      tile_load(tiles + issued * TB, src + (size_t)issued * TB,
                (uint32_t)min(TB, staged - issued * TB), &bars[issued]);
    int k = 0, tend = 0, toff = 0;
    if (n_tiles > 0) {
      mbar_wait(&bars[0], 0);
      tend = min(TB, staged);
    }
    int bits = 0, ip = 0, o = 0, lwf = 0, err = 0, nq = 0, pub = 0;
    const uint32_t tok_a = smem_addr(tok), tiles_a = smem_addr(tiles);
    const uint32_t queue_a = smem_addr(queue);
    const int lim = reg(max_out), Wr = reg(W);
    // the next payload word, big-endian, its bytes past n zeroed; ip is a
    // multiple of 4 until the payload's last word
    auto word = [&]() -> uint32_t {
      if (ip >= tend) {
        // tile k is read: its stage takes tile k + NST; go on in k + 1
        if (issued < n_tiles) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          const int st = issued % NST;
          tile_load(tiles + st * TB, src + (size_t)issued * TB,
                    (uint32_t)min(TB, staged - issued * TB), &bars[st]);
          ++issued;
        }
        ++k;
        mbar_wait(&bars[k % NST], (uint32_t)(k / NST) & 1);
        toff = (k % NST) * TB - k * TB;
        tend = min(k * TB + TB, staged);
      }
      const uint32_t w = __byte_perm(lds32(tiles_a + toff + ip), 0, 0x0123);
      const int nb = min(4, n - ip);
      ip += nb;
      bits += 8 * nb;
      return nb == 4 ? w : w & (0xFFFFFFFFu << (32 - 8 * nb));
    };

    // The held bits left-aligned in (ah, al), ah's top bit the next one,
    // the bits past `bits` zero.  A token needs at most 33 bits, so with 33
    // held no token checks for its bits; fewer are held only at the
    // payload's end (then ip == n).
    uint32_t ah = 0, al = 0;
    auto take = [&](int m) {  // drop the next m (< 32) bits
      ah = __funnelshift_l(al, ah, m);
      al <<= m;
      bits -= m;
    };
    // the bits of the token at (h, l)
    auto token_bits = [&](uint32_t h, uint32_t l) -> int {
      const int e = (int)lds32(tok_a + ((h >> 23) << 2));
      if (!(e & 64)) return e & 63;  // a literal or a basic match
      const int e1 = peek[(h >> 23) & 0xFF];
      const int nb = 1 + (e1 >> 4);
      if ((e1 & 15) == FLUSH_SYM) return nb;
      // RLE: s2 and 4 trail bits; an extended match: s2, 3, the window's
      const int e2 = peek[__funnelshift_l(l, h, nb) >> 24];
      return nb + (e2 >> 4) + ((e1 & 15) == RLE_SYM ? 4 : 3 + wbits);
    };
    // the token at (ah, al): its record to the queue (plain stores), its
    // bits taken; false at a match past the window (ERR_OOB, nothing of
    // it queued)
    auto step = [&]() -> bool {
      // a literal or a basic match, without a branch: the token table
      // gives its bits, its record and where its field lies
      const int e = (int)lds32(tok_a + ((ah >> 23) << 2));
      const int fv = (int)(__funnelshift_l(al, ah, (e >> 20) & 15) >>
                           (32 - (e >> 24)));
      const int tc = (e >> 11) & 0xFF;
      if (!((e & 64) | (fv + tc > Wr))) {  // a literal never reads past W
        sts32(queue_a + ((nq++ & (Q - 1)) << 2), (e >> 8 & 0x7FF) | fv << 11);
        take(e & 63);
        o += tc;
        lwf = 0;
        return true;
      }
      // FLUSH, RLE, an extended match, or a match past the window
      const int e1 = peek[(ah >> 23) & 0xFF];
      const int s1 = e1 & 15;
      take(1 + (e1 >> 4));
      if (s1 == FLUSH_SYM) {
        take(bits & 7);
        if (more && lwf) queue[nq++ & (Q - 1)] = K_RESET;
        lwf = 1;
        return true;
      }
      int cnt, idx = 0, kind;
      if (extended && (s1 == RLE_SYM || s1 == EXT_SYM)) {
        const int e2 = peek[ah >> 24];
        const int s2 = e2 & 15;
        take(e2 >> 4);
        if (s1 == RLE_SYM) {
          cnt = (s2 << 4) + (int)(ah >> 28) + 2;
          take(4);
          kind = K_RLE;
        } else {
          cnt = (s2 << 3) + (int)(ah >> 29) + minp + 12;
          take(3);
          idx = (int)(ah >> (32 - wbits));
          take(wbits);
          kind = K_EXT;
        }
      } else {
        cnt = s1 + minp;
        idx = (int)(ah >> (32 - wbits));
        take(wbits);
        kind = K_MATCH;
      }
      if (kind != K_RLE && idx + cnt > W) {
        err = ERR_OOB;
        return false;
      }
      queue[nq++ & (Q - 1)] = kind | cnt << 3 | idx << 11;
      o += cnt;
      lwf = 0;
      return true;
    };
    auto publish = [&]() {  // and wait for room for the next 40 records
      __threadfence_block();
      *head_v = pub = nq;
      while (nq + 40 - *tail_v > Q) {
      }
    };
    // While 33 bits are held: one branch a token tests for all the rare
    // work (a refill, max_out, publishing the queue).
    for (;;) {
      if ((bits <= 32) | (o >= lim) | (nq - pub >= 32)) {
        if (nq - pub >= 32) publish();
        if (o >= lim) break;
        while (bits <= 32 && ip < n) {
          const int b0 = bits;  // al is 0 here
          const uint32_t w = word();
          if (b0 < 32) {
            ah |= w >> b0;
            al = b0 ? w << (32 - b0) : 0u;
          } else {
            al = w;
          }
        }
        if (bits < 33) break;  // the payload's end: ip == n
      }
      if (!step()) break;
    }
    // The payload's last bits: a token they cannot complete ends the decode
    // quietly, so its bits are counted before it is taken (the bits past
    // `bits` are zero, as the plain version's zero-padded peek).
    while (err == 0 && o < lim && token_bits(ah, al) <= bits) {
      if (nq - pub >= 32) publish();
      step();
    }
    for (int j = k + 1; j < issued; ++j)  // no copy may land after exit
      mbar_wait(&bars[j % NST], (uint32_t)(j / NST) & 1);
    *err_v = err;
    __threadfence_block();
    *head_v = nq;
    __threadfence_block();
    *fin_v = 1;
    return;
  }
  if (threadIdx.x < 32) return;

  // ---- the x2 commit warp: copy the tokens, 32 records a batch ----
  const int lane = threadIdx.x & 31;
  const bool vec = (max_out & 15) == 0 && ((uintptr_t)o_row & 15) == 0;
  int done = 0, out_pos = 0, flushed = 0, head_pos = 0;

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
      if (head == done) break;  // the parse has ended
    }
    __threadfence_block();
    const int nrec = min(32, head - done);
    const bool real = lane < nrec;
    const int32_t w = real ? queue[(done + lane) & (Q - 1)] : 0;
    const int kind = w & 7;
    const bool reset = real && kind == K_RESET;
    const bool live = real && !reset;
    const int cnt = live ? (w >> 3) & 0xFF : 0;
    const int idx = (w >> 11) & M;
    if (__shfl_sync(FULL, (int)reset, 0)) {
      ring_fill(ring, dict_reset, W, lane, 32);  // double FLUSH
      __syncwarp();
      head_pos = 0;
      done += 1;
      if (lane == 0) *tail_v = done;
      continue;
    }
    // ring bytes a token writes if it does not reach the ring end
    const bool clamp = kind == K_EXT || kind == K_RLE;
    const int a = !live ? 0
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
    // the batch ends before a token whose source may hold a byte written
    // earlier in the batch, [head_pos, head_pos + rex) mod W
    bool cut = !real || reset || rex + wr > W ||
               (pmask & ((1u << lane) - 1)) != 0;
    if (kind == K_MATCH || kind == K_EXT)
      cut |= rex > 0 && (((idx - head_pos) & M) < rex ||
                         ((head_pos - idx) & M) < cnt);
    else if (kind == K_RLE)
      cut |= rex > 0;
    const unsigned cmask = __ballot_sync(FULL, cut) & ~1u;
    const int kk = cmask ? __ffs(cmask) - 1 : 32;
    const int rb = ring[(pos - 1) & M];  // an RLE token's byte
    // phase 1: the batch's output bytes from the ring as it was before the
    // batch (loads first: the stage never aliases the ring); lane j copies
    // the first 8 bytes of token j, the warp the rest of each longer token
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
        stage[(oj + m) & (OS - 1)] = kj == K_RLE ? (uint8_t)bj : ring[ij + m];
    }
    __syncwarp();
    // phase 2: the batch's first nr output bytes to the ring at its head
    const int nr = __shfl_sync(FULL, rex + wr, kk - 1);
    for (int r = lane; r < nr; r += 32)
      ring[(head_pos + r) & M] = stage[(out_pos + r) & (OS - 1)];
    __syncwarp();
    out_pos += __shfl_sync(FULL, oin, kk - 1);
    head_pos = (__shfl_sync(FULL, pos + wr, kk - 1)) & M;
    done += kk;
    if (lane == 0) *tail_v = done;
    if (min(out_pos, max_out) - flushed >= FLUSH_AT)
      flush(min(out_pos, max_out) & ~15);
  }
  // the last bytes, zero-padded to a 16-byte boundary (max_out is one when
  // the stores are vectors)
  const int len = min(out_pos, max_out);
  const int last = vec ? (len + 15) & ~15 : len;
  for (int o = len + lane; o < last; o += 32) stage[o & (OS - 1)] = 0;
  __syncwarp();
  flush(last);
  if (lane == 0) {
    lens[s] = len;
    errs[s] = *err_v;
  }
}

}  // namespace

extern "C" int tpt_serial_decode(const void* in, const void* nbytes,
                                 const void* dict_init,
                                 const void* dict_reset, void* out,
                                 void* lens, void* errs, int S, int Lp,
                                 int wbits, int literal, int extended,
                                 int more, int minp, int max_out,
                                 void* stream) {
  if (Lp % 16 != 0 || ((uintptr_t)in & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = CTRL + (size_t)NST * TB + (size_t)Q * 4 + OS +
                      512 * 4 + 256 + ((size_t)1 << wbits);
  cudaError_t e = cudaFuncSetAttribute(
      serial_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  serial_decode_kernel<<<S, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const int32_t*)nbytes, Lp,
      (const uint8_t*)dict_init, (const uint8_t*)dict_reset, (uint8_t*)out,
      (int32_t*)lens, (int32_t*)errs, wbits, literal, extended, more, minp,
      max_out);
  return (int)cudaGetLastError();
}
