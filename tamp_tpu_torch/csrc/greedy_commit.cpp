// Host exact-table committer of the greedy-parity extended encode.
//
// A trimmed copy of the non-planned path of the JAX package's native engine
// (tamp_tpu/_native/tampnative.cpp, Committer and tampn_compress), kept here
// so the port builds and links nothing of tamp_tpu.  It runs the reference
// encoder's greedy walk for the EXTENDED format (RLE and extended-match
// state machines, the growth loop with mid-match relocation, lazy matching
// with its cache, the flush-drain tail) and packs bits, one shard per call.
// Behavioral spec: BrianPugh/tamp tamp/compressor.py:281-447 and
// tamp/_c_src/tamp/compressor.c:437-660.
//
// Tables (the card's cap-16 and probe tables, ops/match_v1.py) are optional.
// Before the first window divergence (an RLE or extended-match window write
// cut short, so the ring stops being the pure input history) a table entry
// is the answer of the exact search; after it the entry only seeds the
// exact chain search, so the output is byte-equal to the reference at every
// configuration.  A length of 0xFF marks a hole (no entry shipped: the
// speculative pull of ops/greedy_predict.py); the committer searches there.
// So the stream never depends on which entries arrive.  With no tables the
// committer is the reference greedy encoder itself.
//
// Left out of the copy: the planned mode (run plans, model history, forced
// RLE, one-shot extended emits), divergence avoidance, the streaming
// handles and the decoders.  The Huffman encode tables are constant data;
// nothing global is written, so calls run in parallel threads.
//
// Build: c++ -O3 -std=c++17 -shared -fPIC (ops/_build.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const uint16_t HUFF_CODE[15] = {0x00, 0x03, 0x08, 0x0B, 0x14, 0x24, 0x26, 0x2B,
                                0x4B, 0x54, 0x94, 0x95, 0xAA, 0x27, 0xAB};
const uint8_t HUFF_BITS[15] = {2, 3, 5, 5, 6, 7, 7, 7, 8, 8, 9, 9, 9, 7, 9};
const int RLE_SYM = 12, EXT_SYM = 13;
const int RLE_TRAIL = 4, EXT_TRAIL = 3;
const int RLE_MAX = 241, RLE_MAX_WIN = 8;
const int LOOKAHEAD = 16;
// smallest window that keeps hashed trigram chains beside the pair chains
const int TRI_MIN_WINDOW = 2048;
// table length marking a position with no shipped entry
const int SPARSE_NONE = 0xFF;

inline int min_pattern_size(int window, int literal) {
  return 2 + (window > (10 + ((literal - 5) << 1)) ? 1 : 0);
}

// ---- bit writer ------------------------------------------------------------
struct BitWriter {
  uint8_t* out; int64_t cap; int64_t n = 0;
  uint64_t acc = 0; int bits = 0; bool overflow = false;
  BitWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}
  inline void put(uint32_t code, int nbits) {
    acc = (acc << nbits) | (code & ((1u << nbits) - 1));
    bits += nbits;
    if (bits >= 8) {
      int nb = bits >> 3;
      if (__builtin_expect(n + nb > cap, 0)) {  // slow path: per-byte check
        while (bits >= 8) {
          if (n >= cap) { overflow = true; bits = 0; return; }
          out[n++] = (uint8_t)(acc >> (bits - 8));
          bits -= 8;
        }
        return;
      }
      do {
        bits -= 8;
        out[n++] = (uint8_t)(acc >> bits);
      } while (bits >= 8);
    }
  }
  inline void pad() {
    if (bits > 0) {
      if (n >= cap) { overflow = true; return; }
      out[n++] = (uint8_t)(acc << (8 - bits));
      bits = 0;
    }
    acc = 0;
  }
  inline void huff(int sym) { put(HUFF_CODE[sym], HUFF_BITS[sym]); }
  inline void ext_value(int value, int trail) {  // secondary huffman + trail
    int sym = value >> trail;
    put(HUFF_CODE[sym], HUFF_BITS[sym] - 1);
    put(value & ((1 << trail) - 1), trail);
  }
};

// Length of the common prefix of a and b, at most limit (word-at-a-time).
inline int match_extent(const uint8_t* a, const uint8_t* b, int limit) {
  int k = 0;
  while (limit - k >= 8) {
    uint64_t wa, wb;
    std::memcpy(&wa, a + k, 8);
    std::memcpy(&wb, b + k, 8);
    uint64_t x = wa ^ wb;
    if (x) return k + (__builtin_ctzll(x) >> 3);
    k += 8;
  }
  while (k < limit && a[k] == b[k]) k++;
  return k;
}

struct SearchResult { int idx; int size; };

// ---- committer -------------------------------------------------------------
struct Committer {
  // config
  int W, wmask, wbits, literal, minp, maxpat;
  bool lazy;
  // input
  const uint8_t* data; int64_t N;
  // tables (null -> the table-less exact search)
  const uint8_t* flen = nullptr; const int32_t* fidx = nullptr;
  const uint8_t* plen = nullptr; const int32_t* pidx = nullptr;
  int full_cap = 0;
  // ring
  std::vector<uint8_t> ring; int pos = 0;
  std::vector<uint8_t> scratch;  // reusable copy buffer
  // Exact 2-byte chains over the linear ring buffer: chead[pair] -> newest
  // absolute write position whose linear pair equals `pair`; cprev[slot]
  // links to the previous occurrence.  Entries older than wpos - W have
  // expired (their slot was overwritten), which also ends walks.  Pairs
  // starting at slot W-1 are never inserted (matches cannot wrap), and the
  // pair crossing the write head (slot pos-1) is checked in chain_search.
  std::vector<int32_t> chead, cprev;
  // Trigram chains (hashed, verified) for windows >= TRI_MIN_WINDOW: any
  // match of length >= 3 starts with a linear trigram, so the trigram walk
  // is exhaustive for those; pair chains stay the source for length 2.
  std::vector<int32_t> chead3, cprev3;
  bool use_tri = false;
  static constexpr int H3_BITS = 15;
  static inline uint32_t h3(uint8_t a, uint8_t b, uint8_t c) {
    uint32_t k = ((uint32_t)a << 16) | ((uint32_t)b << 8) | c;
    return (k * 2654435761u) >> (32 - H3_BITS);
  }
  int64_t wpos = 0;  // absolute write position (rebased before int32 wraps)

  // Divergence bookkeeping: deleted input ranges [from, from + count) (window
  // writes cut short), sorted and disjoint, with the deleted count before.
  struct DelEvent { int64_t from, count, cum_prev; };
  bool diverged = false;
  std::vector<DelEvent> dels;
  // walk state
  int64_t t = 0;
  int rle_count = 0; int64_t rle_start = 0;
  int ext_count = 0; int ext_pos = 0; int64_t ext_start = 0;
  int cached_idx = -1, cached_size = 0;
  BitWriter* bw = nullptr;
  bool excess_bits = false;

  int64_t del_upto(int64_t p) const {  // deleted input positions < p
    if (dels.empty() || p <= dels.front().from) return 0;
    int lo = 0, hi = (int)dels.size();  // last event with from < p
    while (lo < hi) { int mid = (lo + hi) / 2;
      if (dels[mid].from < p) lo = mid + 1; else hi = mid; }
    const DelEvent& e = dels[lo - 1];
    int64_t inside = p - e.from;
    if (inside > e.count) inside = e.count;
    return e.cum_prev + inside;
  }
  void record_deletion(int64_t from, int64_t count) {
    if (!flen) return;  // only table validation reads these
    int64_t base = dels.empty() ? 0 : dels.back().cum_prev + dels.back().count;
    dels.push_back({from, count, base});
    diverged = true;
  }

  inline uint8_t last_ring_byte() const {
    return ring[pos == 0 ? W - 1 : pos - 1];
  }
  inline void ring_push(uint8_t b) {
    if (pos != 0) {  // index the pair starting at the previous slot
      int key = ((int)ring[pos - 1] << 8) | b;
      cprev[pos - 1] = chead[key];
      chead[key] = (int32_t)(wpos - 1);
      if (use_tri && pos >= 2) {  // trigram starting two slots back
        uint32_t h = h3(ring[pos - 2], ring[pos - 1], b);
        cprev3[pos - 2] = chead3[h];
        chead3[h] = (int32_t)(wpos - 2);
      }
    }
    ring[pos] = b;
    wpos++;
    if (++pos == W) pos = 0;
    if (__builtin_expect(wpos >= 0x7F000000LL, 0)) rebase_chains();
  }

  // ring_push over a contiguous source: the same ring and chain state, with
  // the wrap branch out of the inner loop.
  void ring_push_run(const uint8_t* src, int n) {
    uint8_t* rg = ring.data();
    int32_t* cp = cprev.data();
    int32_t* ch = chead.data();
    int32_t* cp3 = use_tri ? cprev3.data() : nullptr;
    int32_t* ch3 = use_tri ? chead3.data() : nullptr;
    while (n > 0) {
      int p = pos;
      int seg = (W - p) < n ? (W - p) : n;
      if (p != 0) {  // pair/trigrams crossing into this run
        int key = ((int)rg[p - 1] << 8) | src[0];
        cp[p - 1] = ch[key];
        ch[key] = (int32_t)(wpos - 1);
        if (cp3) {
          if (p >= 2) {
            uint32_t h = h3(rg[p - 2], rg[p - 1], src[0]);
            cp3[p - 2] = ch3[h];
            ch3[h] = (int32_t)(wpos - 2);
          }
          if (seg >= 2) {
            uint32_t h = h3(rg[p - 1], src[0], src[1]);
            cp3[p - 1] = ch3[h];
            ch3[h] = (int32_t)(wpos - 1);
          }
        }
      }
      rg[p] = src[0];
      if (seg >= 2) {
        int key = ((int)src[0] << 8) | src[1];
        cp[p] = ch[key];
        ch[key] = (int32_t)wpos;
        rg[p + 1] = src[1];
      }
      if (cp3) {
        for (int i = 2; i < seg; i++) {
          int key = ((int)src[i - 1] << 8) | src[i];
          cp[p + i - 1] = ch[key];
          ch[key] = (int32_t)(wpos + i - 1);
          uint32_t h = h3(src[i - 2], src[i - 1], src[i]);
          cp3[p + i - 2] = ch3[h];
          ch3[h] = (int32_t)(wpos + i - 2);
          rg[p + i] = src[i];
        }
      } else {
        for (int i = 2; i < seg; i++) {
          int key = ((int)src[i - 1] << 8) | src[i];
          cp[p + i - 1] = ch[key];
          ch[key] = (int32_t)(wpos + i - 1);
          rg[p + i] = src[i];
        }
      }
      wpos += seg;
      pos = p + seg;
      if (pos == W) pos = 0;
      src += seg;
      n -= seg;
    }
    if (__builtin_expect(wpos >= 0x7F000000LL, 0)) rebase_chains();
  }

  // Keep chain entries within int32: subtract a large constant from wpos
  // and every entry (expired entries clamp to -1).  Runs every ~2 GB.
  void rebase_chains() {
    const int64_t delta = 0x40000000LL;
    wpos -= delta;
    for (auto& v : chead) v = (v < delta) ? -1 : (int32_t)(v - delta);
    for (auto& v : cprev) v = (v < delta) ? -1 : (int32_t)(v - delta);
    for (auto& v : chead3) v = (v < delta) ? -1 : (int32_t)(v - delta);
    for (auto& v : cprev3) v = (v < delta) ? -1 : (int32_t)(v - delta);
  }

  void seed_chains() {  // after the dictionary fills ring[0..W)
    chead.assign(65536, -1);
    cprev.assign((size_t)W, -1);
    use_tri = W >= TRI_MIN_WINDOW;
    if (use_tri) {
      chead3.assign((size_t)1 << H3_BITS, -1);
      cprev3.assign((size_t)W, -1);
    }
    for (int s = 0; s + 1 < W; s++) {
      int key = ((int)ring[s] << 8) | ring[s + 1];
      cprev[s] = chead[key];
      chead[key] = (int32_t)s;
      if (use_tri && s + 2 < W) {
        uint32_t h = h3(ring[s], ring[s + 1], ring[s + 2]);
        cprev3[s] = chead3[h];
        chead3[h] = (int32_t)s;
      }
    }
    wpos = W;
  }

  // Exact window search via the chains: longest match of a prefix of
  // target (at most min(tlen, cap) bytes), lowest ring slot among ties,
  // slots >= start only: the result of a left-to-right scan of the linear
  // buffer.  seed_len/seed_slot: a validated candidate used as the initial
  // lower bound; every chain candidate is still walked, so the result is
  // that of the unseeded search.
  SearchResult chain_search(const uint8_t* target, int tlen, int cap, int start,
                            int seed_len = 0, int seed_slot = -1) {
    int limit = tlen < cap ? tlen : cap;
    if (limit < minp) return {start, 0};
    int64_t lo = wpos - W;
    int best = minp - 1, best_slot = -1;
    if (seed_len >= minp && seed_len <= limit) {
      best = seed_len;
      best_slot = seed_slot;
    }

    const uint8_t* rg = ring.data();

    if (!use_tri) {
      // Small-window path: one exact pair walk with in-walk extension.
      const int32_t* cp = cprev.data();
      auto consider = [&](int x) {
        int room = W - x;
        bool maybe_tie = best_slot >= 0 && x < best_slot;
        if (!maybe_tie) {
          if (best >= limit || room <= best) return;
          if (rg[x + best] != target[best]) return;  // cannot beat best
        } else {
          if (room < best) return;                        // cannot even tie
          if (rg[x + best - 1] != target[best - 1]) return;  // len < best
        }
        int mx = limit < room ? limit : room;
        int len = 2 + match_extent(rg + x + 2, target + 2, mx - 2);
        if (len > best) {
          best = len;
          best_slot = x;
        } else if (len == best && maybe_tie) {
          best_slot = x;
        }
      };
      int key = ((int)target[0] << 8) | target[1];
      for (int64_t c = chead[key]; c >= lo; c = cp[c & wmask]) {
        int x = (int)(c & wmask);
        if (x >= start) consider(x);
      }
      // The head-crossing pair (never chain-indexed).
      int hx = pos - 1;
      if (hx >= 0 && hx >= start && rg[hx] == target[0] &&
          rg[hx + 1] == target[1])
        consider(hx);
      if (best_slot < 0) return {start, minp - 1};
      return {best_slot, best};
    }

    if (limit >= 3) {
      // Phase 1: matches of length >= 3 via the trigram chains; hash
      // collisions are rejected by checking the 2-byte prefix, and length-2
      // outcomes are left to phase 2.
      const int32_t* cp3 = cprev3.data();
      int best0 = best;
      if (best < 2) best = 2;  // floor: only len>=3 can be recorded
      auto consider3 = [&](int x) {
        int room = W - x;
        bool maybe_tie = best_slot >= 0 && x < best_slot;
        if (!maybe_tie) {
          if (best >= limit || room <= best) return;
          if (rg[x + best] != target[best]) return;  // cannot beat best
        } else {
          if (room < best) return;                        // cannot even tie
          if (rg[x + best - 1] != target[best - 1]) return;  // len < best
        }
        if (rg[x] != target[0] || rg[x + 1] != target[1]) return;  // collision
        int mx = limit < room ? limit : room;
        int len = 2 + match_extent(rg + x + 2, target + 2, mx - 2);
        if (len > best) {
          best = len;
          best_slot = x;
        } else if (len == best && maybe_tie) {
          best_slot = x;
        }
      };
      uint32_t h = h3(target[0], target[1], target[2]);
      for (int64_t c = chead3[h]; c >= lo; c = cp3[c & wmask]) {
        int x = (int)(c & wmask);
        if (x >= start) consider3(x);
      }
      // Trigram starts next to the write head hold newer bytes than their
      // (expired) chain entries recorded: check them explicitly.
      for (int dx = 2; dx >= 1; dx--) {
        int x = pos - dx;
        if (x >= 0 && x >= start) consider3(x);
      }
      if (best >= 3) return {best_slot, best};
      best = best0;  // nothing >= 3 (tie updates to best_slot were valid
                     // pair matches; phase 2 keeps minimizing the slot)
    }

    // Phase 2: the longest match is (at most) 2; the lowest pair slot wins.
    if (minp <= 2) {
      const int32_t* cp = cprev.data();
      int key = ((int)target[0] << 8) | target[1];
      for (int64_t c = chead[key]; c >= lo; c = cp[c & wmask]) {
        int x = (int)(c & wmask);
        if (x >= start && (best_slot < 0 || x < best_slot)) {
          best = 2;
          best_slot = x;
        }
      }
      int hx = pos - 1;  // the head-crossing pair
      if (hx >= 0 && hx >= start && (best_slot < 0 || hx < best_slot) &&
          rg[hx] == target[0] && rg[hx + 1] == target[1]) {
        best = 2;
        best_slot = hx;
      }
    }

    if (best_slot < 0) return {start, minp - 1};
    return {best_slot, best};
  }
  // snapshot-read size bytes at index (mod wrap), then append at pos (wrap)
  void ring_copy_wrap(int index, int size) {
    uint8_t tmp[16];  // cached lazy matches are <= 15 bytes
    for (int i = 0; i < size; i++) tmp[i] = ring[(index + i) & wmask];
    ring_push_run(tmp, size);
  }
  // extended-match window write: no wrap past the ring end
  void ring_selfcopy_ext(int index, int size, int64_t src_input_start) {
    int wr = size < (W - pos) ? size : (W - pos);
    scratch.resize((size_t)wr);
    for (int i = 0; i < wr; i++) scratch[i] = ring[(index + i) & wmask];
    ring_push_run(scratch.data(), wr);
    if (wr < size) record_deletion(src_input_start + wr, size - wr);
  }

  // Map a table candidate (ring slot x of the pure input history at input
  // position tt, length len) onto the true ring.  Returns the slot, or -1
  // when the candidate cannot stand (it wraps, crosses a deleted range,
  // has expired, or is no longer linear).
  int validate(int64_t tt, int x, int len) {
    int tau = (int)(tt & wmask);
    int j = x - tau; if (j < 0) j += W;
    if (j + len > W) return -1;          // wrap-glued candidate
    int64_t p_src = tt + j - W;          // may be negative: dictionary bytes
    int64_t d_lo = p_src > 0 ? del_upto(p_src) : 0;
    int64_t d_hi = del_upto(p_src + len > 0 ? p_src + len : 0);
    if (d_hi != d_lo) return -1;         // a deletion inside the range
    int64_t k_s = p_src - d_lo;
    int64_t k_now = t - (dels.empty() ? 0 : dels.back().cum_prev +
                                                dels.back().count);
    if (k_s < k_now - W) return -1;      // expired from the true window
    int slot = (int)(k_s & wmask);
    if (slot + len > W) return -1;       // true ring-linearity
    return slot;
  }

  // One table lookup: the entry verbatim before the first divergence, a
  // seeded exact search after it, the exact search at a hole.  Tables serve
  // the steady state only (rem >= 16); the < 16-byte flush drain replays
  // the reference's shrinking search.
  SearchResult table_search(const uint8_t* lens, const int32_t* idxs,
                            const uint8_t* target, int tl, int cap) {
    int len = lens[t]; int x = idxs[t];
    if (len == SPARSE_NONE) return chain_search(target, tl, cap, 0);
    if (len > cap) len = cap;
    if (!diverged) return {x, len};
    int slot = (len >= minp) ? validate(t, x, len) : -1;
    if (slot >= 0) return chain_search(target, tl, cap, 0, len, slot);
    return chain_search(target, tl, cap, 0);
  }

  SearchResult first_search(int64_t rem) {
    int cap = (int)(rem < full_cap ? rem : full_cap);
    int tl = (int)(rem < LOOKAHEAD ? rem : LOOKAHEAD);
    if (flen && rem >= LOOKAHEAD) return table_search(flen, fidx, data + t, tl, cap);
    return chain_search(data + t, tl, cap, 0);
  }

  SearchResult probe_search(int64_t rem) {  // target data[t+1:], current ring
    int cap = 15 < maxpat ? 15 : maxpat;
    if ((int64_t)(rem - 1) < cap) cap = (int)(rem - 1);
    int tl = (int)((rem - 1) < 15 ? (rem - 1) : 15);
    if (plen && rem >= LOOKAHEAD)
      return table_search(plen, pidx, data + t + 1, tl, cap);
    return chain_search(data + t + 1, tl, cap, 0);
  }

  bool emit_literal(uint8_t b) {
    if (literal < 8 && (b >> literal)) { excess_bits = true; return false; }
    bw->put((1u << literal) | b, literal + 1);
    ring_push(b);
    return true;
  }
  void emit_match(int idx, int size) {
    bw->huff(size - minp);
    bw->put((uint32_t)idx, wbits);
    // matched bytes equal the consumed input; write them with wrap
    ring_push_run(data + t, size);
  }
  void emit_match_cached(int idx, int size) {
    bw->huff(size - minp);
    bw->put((uint32_t)idx, wbits);
    ring_copy_wrap(idx, size);
  }
  void emit_rle() {
    int count = rle_count; rle_count = 0;
    uint8_t b = last_ring_byte();
    if (count == 1) { emit_literal(b); return; }
    bw->huff(RLE_SYM);
    bw->ext_value(count - 2, RLE_TRAIL);
    int wr = count; if (wr > RLE_MAX_WIN) wr = RLE_MAX_WIN;
    if (wr > W - pos) wr = W - pos;
    uint8_t fill[RLE_MAX_WIN];
    std::memset(fill, b, sizeof fill);
    ring_push_run(fill, wr);
    if (wr < count) record_deletion(rle_start + wr, count - wr);
  }
  void emit_ext_match() {
    bw->huff(EXT_SYM);
    bw->ext_value(ext_count - minp - 12, EXT_TRAIL);
    bw->put((uint32_t)ext_pos, wbits);
    ring_selfcopy_ext(ext_pos, ext_count, ext_start);
    ext_count = 0; ext_pos = 0;
  }

  // one reference "poll": consume input until one token (or buffer need)
  void step() {
    int64_t rem = N - t;
    if (rem <= 0) return;

    // --- extended-match continuation -----------------------------------
    if (ext_count) {
      cached_idx = -1;
      // The growth target is exactly the input bytes the match reproduces.
      while (t < N) {
        if (ext_pos + ext_count >= W) { emit_ext_match(); return; }
        const uint8_t* target = data + ext_start;
        // In-place extension: ext_pos is the lowest index >= the search
        // start, so when the current location extends it IS the search
        // result (compressor.py:304); skip the chain walk.
        if (ring[ext_pos + ext_count] == target[ext_count]) {
          t++;
          ext_count++;
          if (ext_count == maxpat) { emit_ext_match(); return; }
          continue;
        }
        SearchResult r = chain_search(target, ext_count + 1, maxpat, ext_pos);
        if (r.size > ext_count) {
          t++;
          ext_count = r.size; ext_pos = r.idx;
          if (ext_count == maxpat) { emit_ext_match(); return; }
        } else {
          emit_ext_match(); return;
        }
      }
      return;  // drained input while growing
    }

    // --- RLE accumulation / decision -----------------------------------
    uint8_t last = last_ring_byte();
    int pend = (int)(rem < LOOKAHEAD ? rem : LOOKAHEAD);
    int avail = 0;
    while (avail < pend && data[t + avail] == last &&
           rle_count + avail < RLE_MAX) avail++;
    int total = rle_count + avail;
    bool ended = (avail < pend) || (total >= RLE_MAX);
    if (!ended && total > 0) {
      cached_idx = -1;
      if (rle_count == 0) rle_start = t;
      rle_count = total;
      t += avail;
      return;
    }
    if (total >= 2) {
      bool use_pattern = false;
      if (total == avail && total <= 6) {
        SearchResult r = first_search(rem);
        if (r.size > total) use_pattern = true;
      }
      if (!use_pattern) {
        cached_idx = -1;
        if (rle_count == 0) rle_start = t;
        t += avail;
        rle_count = total;
        emit_rle();
        return;
      }
      rle_count = 0;
    } else if (total == 1) {
      if (rle_count == 1) { cached_idx = -1; emit_rle(); return; }
      rle_count = 0;
    }

    // --- pattern matching ----------------------------------------------
    int idx, size;
    bool from_cache = false;
    if (lazy && cached_idx >= 0 && (int64_t)cached_size <= rem) {
      idx = cached_idx; size = cached_size; cached_idx = -1; from_cache = true;
    } else {
      cached_idx = -1;
      SearchResult r = first_search(rem);
      idx = r.idx; size = r.size;
    }

    if (lazy && size >= minp && size <= 8 && pend > size + 2) {
      SearchResult p = probe_search(rem);
      int tau = pos;  // true ring write head == reference window pos
      if (p.size > size && !(p.idx <= tau && tau < p.idx + p.size)) {
        if (!emit_literal(data[t])) return;
        cached_idx = p.idx; cached_size = p.size;
        t++;
        return;
      }
    }

    if (size >= minp) {
      if (size > minp + 11) {
        ext_pos = idx; ext_count = size; ext_start = t;
        t += size;
      } else {
        if (from_cache) emit_match_cached(idx, size);
        else emit_match(idx, size);
        t += size;
      }
    } else {
      if (!emit_literal(data[t])) return;
      t++;
    }
  }

  int run(BitWriter& writer) {
    bw = &writer;
    while (t < N) {
      step();
      if (excess_bits) return -2;
      if (bw->overflow) return -1;
    }
    // flush drain: pending RLE / extended state
    if (rle_count) emit_rle();
    if (ext_count) emit_ext_match();
    if (excess_bits) return -2;
    bw->pad();
    if (bw->overflow) return -1;
    return 0;
  }
};

}  // namespace

extern "C" {

// One extended-format Tamp stream (header included) of data[0..n).
// flen/fidx: the cap-16 table (length, ring slot), 0xFF length = hole; null
// for the table-less exact search.  plen/pidx: the lazy probe table, the
// same way (null without tables or without lazy matching).  dict: the
// initial window, 1 << window bytes; custom_dict sets the header's flag.
// out_cap >= 16 + n + n * (1 + literal) / 8 always suffices.
// Returns 0 ok, -1 output full, -2 a literal wider than `literal` bits.
int tpt_greedy_compress(const uint8_t* data, int64_t n, const uint8_t* flen,
                        const int32_t* fidx, const uint8_t* plen,
                        const int32_t* pidx, const uint8_t* dict, int window,
                        int literal, int lazy, int custom_dict, uint8_t* out,
                        int64_t out_cap, int64_t* out_len) {
  Committer c;
  c.W = 1 << window; c.wmask = c.W - 1; c.wbits = window; c.literal = literal;
  c.minp = min_pattern_size(window, literal);
  c.maxpat = c.minp + 131;
  c.lazy = lazy != 0;
  c.data = data; c.N = n;
  c.flen = flen; c.fidx = fidx; c.plen = plen; c.pidx = pidx;
  c.full_cap = LOOKAHEAD;  // min(16, maxpat)
  c.ring.assign(dict, dict + c.W);
  c.seed_chains();

  BitWriter bw(out, out_cap);
  uint32_t h = (uint32_t)(((window - 8) << 5) | ((literal - 5) << 3) |
                          ((custom_dict ? 1 : 0) << 2) | (1 << 1));
  bw.put(h, 8);
  int rc = c.run(bw);
  *out_len = bw.n;
  return rc;
}

}  // extern "C"
