// Host table committer of the device-table encodes.
//
// A copy of the one-shot path of the JAX package's native engine
// (tamp_tpu/_native/tampnative.cpp, Committer and tampn_compress), kept here
// so the port builds and links nothing of tamp_tpu.  It runs the reference
// encoder's greedy walk (RLE and extended-match state machines, the growth
// loop with mid-match relocation, lazy matching with its cache, the
// flush-drain tail) over per-position match tables and packs bits, one
// stream per call.  Behavioral spec: BrianPugh/tamp tamp/compressor.py:281-447
// and tamp/_c_src/tamp/compressor.c:437-660.
//
// The table encodes write the extended format (max pattern minp + 131, RLE
// and extended symbols); the port's v1 streams come from the card's commit
// kernels.  The walk also keeps the native engine's v1 mode (``extended``
// off: no RLE or extended tokens, max pattern minp + 13), which the
// streaming handles of csrc/stream.cpp use.
//
// Tables (the card's cap-16 and probe tables, ops/match_v1.py)
// are optional; with none the committer is the reference greedy encoder.
// Before the first window divergence (an RLE or extended-match window write
// cut short at the ring end, so the ring stops being the history the tables
// were computed against) an entry is used verbatim.  After it:
// - exact-table mode (exact_tables = 1, the greedy-parity encode): the
//   entry only seeds the exact chain search, so the stream is byte-equal
//   to the reference at every configuration;
// - table mode (exact_tables = 0, engine="device"): the entry is trusted
//   once it is validated against the true write history (deleted ranges,
//   residency, ring-linearity), a "no match" entry of the first search is
//   trusted as it is, and an entry that cannot stand falls back to the
//   exact search.
// A length of 0xFF marks a hole (no entry shipped: the speculative pull of
// ops/greedy_predict.py); the committer searches there.
//
// Options of table mode (engine/encode_extended.py):
// - divergence avoidance: an extended match that would cross the ring end
//   is cut to fill the ring exactly (or becomes a basic match when the room
//   is below an extended token's), and the rest is tokenized again;
// - the planned mode: run plans (rle_start, end) with khat, the model write
//   counts of the planned history; tables are indexed by input position but
//   hold model-history answers, planned runs are forced RLE chunks whose
//   window writes follow khat, no token crosses a plan's start, RLE tokens
//   split at the ring end, extended matches are searched once over the
//   model stream dh (the kept bytes), the lazy rule is the pure-position
//   one (no cache, steady state only), and the flush drain loops over
//   split remainders.
//
// Also copied, for the optimal extended encode (engine/pipeline_ext.py):
// the per-position exact tables of the v1 ring model at any cap, with the
// khat write counts of forced RLE (tampn_v1_tables, its prefix-property
// seed kept as it is so that fidx stays the lowest slot among ties), and
// the walk that expands the card's choice plane into tokens
// (tampn_opt_ext_walk); and the host minimum-bit v1 parse
// (tampn_opt_v1_plan), the reference that bench_torch.py holds the card's
// optimal v1 encode to.
//
// And the host half of the planned extended encode, on its main path
// (engine/pipeline_ext.encode_ext_device_commit, a thread a shard): the
// one-pass run plan, model history and chunk counts (tampn_ext_prep, also
// the model inputs of engine="device") and the tail walk that finishes a
// shard after the card's commit kernel (tampn_ext_tail_bits: the planned
// walk resumed over a replayed ring, no table rows).  engine/plan.py and
// engine/tail.py are their plain versions, reached only by the tests.
//
// The streaming handles (incremental write, flush, dictionary reset,
// progress callbacks) and the stream decoder are in csrc/stream.cpp, which
// includes this file.  Left out of the copy: the native engine's one-shot
// decoder and its v1 table encode (engine="device" sends v1 to the card's
// commit kernels, engine/pipeline.encode_v1_device_commit, whose streams
// are the same reference greedy ones).  The Huffman encode tables are
// constant data; nothing global is written, so calls run in parallel
// threads.
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
  bool extended = true, lazy = false;
  // Split extended matches at the ring end instead of truncating the window
  // write (one more token a ring cycle, no divergence).
  bool avoid_divergence = false;
  // After a divergence the table entry only seeds the exact search
  // (reference byte parity) instead of being trusted once validated.
  bool exact_tables = false;
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
  // Run plan (planned mode): runs of >= 9 bytes are RLE'd at fixed
  // positions, so their window-write truncations are part of the model the
  // tables were computed against.  khat[t] = model-written bytes among input
  // positions < t; plan = sorted (rle_start, end) pairs; no token may cross
  // an rle_start.  A non-null plan with n_plan = 0 is the planned mode
  // without runs.
  const uint32_t* khat = nullptr;
  const int64_t* plan = nullptr; int n_plan = 0;
  int plan_i = 0;
  // The model stream dh (the kept bytes, M = khat[N]): planned searches
  // without a table target it, not the input, since past a plan boundary
  // the two differ and can flip the lowest-slot tie-break of a capped match.
  const uint8_t* dh = nullptr; int64_t M = 0;
  std::vector<uint8_t> dh_own;
  inline int64_t chat(int64_t p) const {  // input position -> model position
    return khat ? (int64_t)khat[p] : p;
  }
  inline int64_t boundary() const {  // next uncrossable token boundary
    return plan_i < n_plan ? plan[2 * plan_i] : INT64_MAX;
  }

  // Divergence bookkeeping: deleted model-coordinate ranges
  // [from, from + count) (window writes cut short), sorted and disjoint,
  // with the deleted count before.
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
  // How each table_search ended (tpt_greedy_compress's stats): lookups,
  // entries taken without a search, searches at a hole, searches seeded
  // from the entry after a divergence, unseeded searches after one.
  int64_t n_lookups = 0, n_hits = 0, n_holes = 0, n_seeded = 0, n_full = 0;

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
    if (wr < size) record_deletion(chat(src_input_start) + wr, size - wr);
  }

  // Map a table candidate (ring slot x of the model history at input
  // position tt, length len) onto the true ring, in model coordinates.
  // Returns the slot, or -1 when the candidate cannot stand (it wraps,
  // crosses a deleted range, has expired, or is no longer linear).
  int validate(int64_t tt, int x, int len) {
    int64_t ct = chat(tt);
    int tau = (int)(ct & wmask);
    int j = x - tau; if (j < 0) j += W;
    if (j + len > W) return -1;          // wrap-glued candidate
    int64_t p_src = ct + j - W;          // may be negative: dictionary bytes
    int64_t d_lo = p_src > 0 ? del_upto(p_src) : 0;
    int64_t d_hi = del_upto(p_src + len > 0 ? p_src + len : 0);
    if (d_hi != d_lo) return -1;         // a deletion inside the range
    int64_t k_s = p_src - d_lo;
    int64_t k_now = chat(t) - (dels.empty() ? 0 : dels.back().cum_prev +
                                                      dels.back().count);
    if (k_s < k_now - W) return -1;      // expired from the true window
    int slot = (int)(k_s & wmask);
    if (slot + len > W) return -1;       // true ring-linearity
    return slot;
  }

  // One table lookup: the exact search at a hole, the entry verbatim
  // before the first divergence; after it a seeded exact search
  // (exact_tables) or the validated entry, with the exact search where it
  // cannot stand.  ``first``: the first search trusts a "no match" entry in
  // table mode (a coverage loss only), the probe does not.
  SearchResult table_search(const uint8_t* lens, const int32_t* idxs,
                            const uint8_t* target, int tl, int cap,
                            bool first) {
    n_lookups++;
    int len = lens[t]; int x = idxs[t];
    if (len == SPARSE_NONE) {
      n_holes++;
      return chain_search(target, tl, cap, 0);
    }
    if (len > cap) len = cap;
    if (!diverged) { n_hits++; return {x, len}; }
    if (exact_tables) {
      int slot = (len >= minp) ? validate(t, x, len) : -1;
      if (slot >= 0) {
        n_seeded++;
        return chain_search(target, tl, cap, 0, len, slot);
      }
      n_full++;
      return chain_search(target, tl, cap, 0);
    }
    if (first && len < minp) { n_hits++; return {x, len}; }
    if (len >= minp) {
      int slot = validate(t, x, len);  // probe slots share the t-basis
      if (slot >= 0) { n_hits++; return {slot, len}; }
    }
    n_full++;
    return chain_search(target, tl, cap, 0);
  }

  // ``rem``: the look-ahead, capped at the next plan boundary in planned
  // mode.  Without a plan the tables serve the steady state only
  // (rem >= 16) and the < 16-byte flush drain replays the reference's
  // shrinking search; in planned mode they serve every position.
  SearchResult first_search(int64_t rem) {
    int cap = (int)(rem < full_cap ? rem : full_cap);
    int tl = (int)(rem < LOOKAHEAD ? rem : LOOKAHEAD);
    if (flen && (plan || rem >= LOOKAHEAD))
      return table_search(flen, fidx, data + t, tl, cap, true);
    if (plan && dh) {
      // The device planner's rule: longest over the model target at full
      // cap, lowest slot among the longest, then the boundary cap keeping
      // the slot.
      int64_t mt = chat(t);
      int mtl = (int)((M - mt) < LOOKAHEAD ? (M - mt) : LOOKAHEAD);
      SearchResult r = chain_search(dh + mt, mtl, full_cap, 0);
      if (r.size > cap) r.size = cap;
      return r;
    }
    return chain_search(data + t, tl, cap, 0);
  }

  SearchResult probe_search(int64_t rem) {  // target data[t+1:], current ring
    int cap = 15 < maxpat ? 15 : maxpat;
    if ((int64_t)(rem - 1) < cap) cap = (int)(rem - 1);
    int tl = (int)((rem - 1) < 15 ? (rem - 1) : 15);
    if (plen && (plan || rem >= LOOKAHEAD))
      return table_search(plen, pidx, data + t + 1, tl, cap, false);
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
    if (plan) {
      // Planned mode: an RLE window write that would be cut at the ring end
      // is split there instead.  Steady-state splits happen in step(); this
      // path sees accumulated counts (the drain), whose remainder stays
      // accumulated.
      int wr0 = count < RLE_MAX_WIN ? count : RLE_MAX_WIN;
      int r = W - pos;
      if (wr0 > r) {
        if (r >= 2) {
          bw->huff(RLE_SYM);
          bw->ext_value(r - 2, RLE_TRAIL);
          uint8_t fill[RLE_MAX_WIN];
          std::memset(fill, b, sizeof fill);
          ring_push_run(fill, r);  // fills exactly to the ring end
          rle_count = count - r;
          rle_start += r;
          return;
        }
        if (!emit_literal(b)) return;  // r == 1: one literal crosses the end
        rle_count = count - 1;
        rle_start += 1;
        return;
      }
    }
    bw->huff(RLE_SYM);
    bw->ext_value(count - 2, RLE_TRAIL);
    int wr = count; if (wr > RLE_MAX_WIN) wr = RLE_MAX_WIN;
    if (wr > W - pos) wr = W - pos;
    uint8_t fill[RLE_MAX_WIN];
    std::memset(fill, b, sizeof fill);
    ring_push_run(fill, wr);
    if (wr < count) record_deletion(chat(rle_start) + wr, count - wr);
  }

  // A planned run: cover [t, end) with RLE chunks of at most 241 bytes,
  // never leaving a single trailing byte (the chunks engine/plan.py put in
  // the model); each chunk writes khat's kept count into the window, and a
  // write cut short beyond it is a deletion.
  void forced_rle(int64_t end) {
    cached_idx = -1;
    uint8_t b = last_ring_byte();
    while (t < end) {
      int64_t remn = end - t;
      int count = remn < RLE_MAX ? (int)remn : RLE_MAX;
      if (remn - count == 1) count--;
      bw->huff(RLE_SYM);
      bw->ext_value(count - 2, RLE_TRAIL);
      int w_plan = (int)(khat[t + count] - khat[t]);
      int wr = w_plan < (W - pos) ? w_plan : (W - pos);
      uint8_t fill[RLE_MAX_WIN];
      std::memset(fill, b, sizeof fill);
      ring_push_run(fill, wr);
      if (wr < w_plan) record_deletion(chat(t) + wr, w_plan - wr);
      t += count;
    }
  }

  // Divergence avoidance at the ring end: an extended token of ``room``
  // bytes that fills the ring exactly, or where the room is below an
  // extended token's a basic match of at most minp + 11 (its write wraps).
  // Returns the bytes consumed from ``from``; the rest is tokenized again.
  int64_t emit_at_ring_end(int idx, int m, int64_t from) {
    int room = W - pos;
    if (room >= minp + 12) {
      bw->huff(EXT_SYM);
      bw->ext_value(room - minp - 12, EXT_TRAIL);
      bw->put((uint32_t)idx, wbits);
      ring_selfcopy_ext(idx, room, from);
      return room;
    }
    int L = m < minp + 11 ? m : minp + 11;
    bw->huff(L - minp);
    bw->put((uint32_t)idx, wbits);
    ring_push_run(data + from, L);
    return L;
  }

  void emit_ext_match() {
    if (avoid_divergence && ext_count > W - pos) {
      t = ext_start + emit_at_ring_end(ext_pos, ext_count, ext_start);
      ext_count = 0; ext_pos = 0;
      return;
    }
    bw->huff(EXT_SYM);
    bw->ext_value(ext_count - minp - 12, EXT_TRAIL);
    bw->put((uint32_t)ext_pos, wbits);
    ring_selfcopy_ext(ext_pos, ext_count, ext_start);
    ext_count = 0; ext_pos = 0;
  }

  // Planned-mode extended emit (one-shot, no growth state): the longest
  // match over the model stream (lowest slot among the longest), capped at
  // the plan boundary keeping the slot, as the device planner finds it from
  // one max-length table.  A longer match's prefix is a match at the same
  // slot, so the cap is valid.
  void emit_ext_planned(int idx, int m) {
    if (avoid_divergence && m > W - pos) {
      t += emit_at_ring_end(idx, m, t);
      return;
    }
    bw->huff(EXT_SYM);
    bw->ext_value(m - minp - 12, EXT_TRAIL);
    bw->put((uint32_t)idx, wbits);
    ring_selfcopy_ext(idx, m, t);
    t += m;
  }

  // one reference "poll": consume input until one token (or buffer need)
  void step() {
    int64_t rem = N - t;
    if (rem <= 0) return;

    // --- planned-run boundaries ----------------------------------------
    int64_t B = INT64_MAX;  // no token may extend to or past this position
    if (plan) {
      while (plan_i < n_plan && t >= plan[2 * plan_i + 1]) plan_i++;
      B = boundary();
      // The forced RLE fires once any pending extended match is out
      // (tokens stay in stream order).
      if (!ext_count && plan_i < n_plan && t == plan[2 * plan_i]) {
        int64_t end = plan[2 * plan_i + 1];
        plan_i++;
        forced_rle(end);
        return;
      }
      if (B - t < rem) rem = B - t;  // cap the effective look-ahead
    }

    // --- extended-match continuation -----------------------------------
    if (ext_count) {
      cached_idx = -1;
      // The growth target is exactly the input bytes the match reproduces.
      while (t < N) {
        if (plan && t >= B) { emit_ext_match(); return; }
        if (ext_pos + ext_count >= W) { emit_ext_match(); return; }
        const uint8_t* target = data + ext_start;
        // In-place extension: ext_pos is the lowest index >= the search
        // start, so when the current location extends it IS the search
        // result (compressor.py:304); skip the chain walk.
        if (!plan && ring[ext_pos + ext_count] == target[ext_count]) {
          t++;
          ext_count++;
          if (ext_count == maxpat) { emit_ext_match(); return; }
          continue;
        }
        // Relocation search; the planned mode searches the whole window.
        SearchResult r = chain_search(target, ext_count + 1, maxpat,
                                      plan ? 0 : ext_pos);
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

    // --- RLE accumulation / decision (extended format) -----------------
    int pend = (int)(rem < LOOKAHEAD ? rem : LOOKAHEAD);
    if (extended) {
      uint8_t last = last_ring_byte();
      int avail = 0;
      while (avail < pend && data[t + avail] == last &&
             rle_count + avail < RLE_MAX) avail++;
      int total = rle_count + avail;
      bool ended = (avail < pend) || (total >= RLE_MAX);
      // A run reaching a plan boundary cannot continue: emit it now so no
      // pending count leaks into the forced-RLE region.
      if (plan && t + avail >= B) ended = true;
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
          if (plan && rle_count == 0) {
            // Steady-state ring-end split: consume only up to the ring end
            // so the remainder re-enters the full decision at the next
            // step, as the device planner's next walk entry does.
            int wr0 = total < RLE_MAX_WIN ? total : RLE_MAX_WIN;
            int r = W - pos;
            if (wr0 > r) {
              if (r >= 2) {
                t += r;
                rle_count = r;
                emit_rle();
                return;
              }
              if (!emit_literal(data[t])) return;  // r == 1
              t += 1;
              return;
            }
          }
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

    // The planned lazy rule is pure-position (the device planner's): the
    // deferral fires only in the steady state, and no match is cached.
    if (lazy && size >= minp && size <= 8 && pend > size + 2 &&
        (!plan || rem >= LOOKAHEAD)) {
      SearchResult p = probe_search(rem);
      int tau = pos;  // true ring write head == reference window pos
      if (p.size > size && !(p.idx <= tau && tau < p.idx + p.size)) {
        if (!emit_literal(data[t])) return;
        if (!plan) { cached_idx = p.idx; cached_size = p.size; }
        t++;
        return;
      }
    }

    if (size >= minp) {
      if (extended && size > minp + 11) {
        if (plan && !from_cache) {
          // One-shot: the longest match over the model stream, capped at
          // the plan boundary keeping its slot (emit_ext_planned).
          SearchResult r;
          if (dh) {
            int64_t mt = chat(t);
            int tl = (int)((M - mt) < (int64_t)maxpat ? (M - mt)
                                                      : (int64_t)maxpat);
            r = chain_search(dh + mt, tl, maxpat, 0);
          } else {
            r = chain_search(
                data + t, (int)(N - t < (int64_t)maxpat ? N - t : maxpat),
                maxpat, 0);
          }
          int m = (int)((int64_t)r.size < rem ? (int64_t)r.size : rem);
          emit_ext_planned(r.idx, m);
          return;
        }
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
    while (true) {
      while (t < N) {
        step();
        if (excess_bits) return -2;
        if (bw->overflow) return -1;
      }
      // Flush drain: pending RLE / extended state.  A ring-end split can
      // leave an RLE remainder, and a divergence-avoiding extended emit can
      // hand back unconsumed bytes (t < N): keep going.
      while (rle_count) {
        emit_rle();
        if (excess_bits || bw->overflow) break;
      }
      if (ext_count) emit_ext_match();
      if (excess_bits) return -2;
      if (bw->overflow) return -1;
      if (t >= N) break;
    }
    bw->pad();
    if (bw->overflow) return -1;
    return 0;
  }
};

// tpt_table_compress's body; ``stats`` (nullable) receives the committer's
// five table_search counts.
int table_compress(const uint8_t* data, int64_t n, const uint8_t* flen,
                   const int32_t* fidx, const uint8_t* plen,
                   const int32_t* pidx, const uint8_t* dict, int window,
                   int literal, int lazy, int custom_dict,
                   int avoid_divergence, int exact_tables,
                   const uint32_t* khat, const int64_t* plan, int n_plan,
                   uint8_t* out, int64_t out_cap, int64_t* out_len,
                   int64_t* stats) {
  *out_len = 0;
  if (!dict || (plan && !khat)) return -3;
  Committer c;
  c.W = 1 << window; c.wmask = c.W - 1; c.wbits = window; c.literal = literal;
  c.minp = min_pattern_size(window, literal);
  c.maxpat = c.minp + 131;
  c.lazy = lazy != 0;
  c.avoid_divergence = avoid_divergence != 0;
  c.exact_tables = exact_tables != 0;
  c.data = data; c.N = n;
  c.khat = khat; c.plan = plan; c.n_plan = n_plan;
  if (c.plan) {
    // the model stream of the planned mode's searches (Committer::dh)
    c.M = (int64_t)khat[n];
    c.dh_own.resize((size_t)c.M);
    for (int64_t p = 0; p < n; p++)
      if (khat[p + 1] > khat[p]) c.dh_own[khat[p]] = data[p];
    c.dh = c.dh_own.data();
  }
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
  if (stats) {
    stats[0] = c.n_lookups; stats[1] = c.n_hits; stats[2] = c.n_holes;
    stats[3] = c.n_seeded; stats[4] = c.n_full;
  }
  return rc;
}

}  // namespace

extern "C" {

// One extended-format Tamp stream (header included) of data[0..n) from the
// card's tables: the arguments of the native engine's tampn_compress with
// extended and write_header fixed to 1 and dict required (the caller passes
// the initial window).  flen/fidx: the cap-16 table (nullable), plen/pidx
// the probe table (nullable); exact_tables: 1 exact-table mode, 0 table
// mode; khat: n + 1 model write counts (nullable without a plan);
// plan/n_plan: sorted (rle_start, end) pairs (null: no plan; non-null with
// n_plan = 0: the planned mode without runs).  out_cap >= 16 + n +
// n * (1 + literal) / 8 always suffices.  Returns 0 ok, -1 output full, -2
// a literal wider than `literal` bits, -3 a null dict or a plan without
// khat.
int tpt_table_compress(const uint8_t* data, int64_t n, const uint8_t* flen,
                       const int32_t* fidx, const uint8_t* plen,
                       const int32_t* pidx, const uint8_t* dict, int window,
                       int literal, int lazy, int custom_dict,
                       int avoid_divergence, int exact_tables,
                       const uint32_t* khat, const int64_t* plan, int n_plan,
                       uint8_t* out, int64_t out_cap, int64_t* out_len) {
  return table_compress(data, n, flen, fidx, plen, pidx, dict, window,
                        literal, lazy, custom_dict, avoid_divergence,
                        exact_tables, khat, plan, n_plan, out, out_cap,
                        out_len, nullptr);
}

// One extended-format stream of the greedy-parity encode: exact-table mode,
// no plan.  flen/fidx: the cap-16 table (length, ring slot), 0xFF length =
// hole; null for the table-less exact search.  plen/pidx: the lazy probe
// table, the same way (null without tables or without lazy matching).
// dict: the initial window, 1 << window bytes; custom_dict sets the
// header's flag.  stats: null, or 5 slots that receive how the table lookups
// ended: lookups, entries taken without a search (before the first
// divergence), searches at a hole, searches seeded from the entry after a
// divergence, unseeded searches after one.  Returns as tpt_table_compress.
int tpt_greedy_compress(const uint8_t* data, int64_t n, const uint8_t* flen,
                        const int32_t* fidx, const uint8_t* plen,
                        const int32_t* pidx, const uint8_t* dict, int window,
                        int literal, int lazy, int custom_dict, uint8_t* out,
                        int64_t out_cap, int64_t* out_len, int64_t* stats) {
  return table_compress(data, n, flen, fidx, plen, pidx, dict, window,
                        literal, lazy, custom_dict, 0, 1, nullptr, nullptr, 0,
                        out, out_cap, out_len, stats);
}

// Exact per-position tables of data[0..n) against the v1 ring model
// dict || data: flen[t] the longest match (0 below minp) capped at cap,
// fidx[t] its lowest ring slot.  khat (nullable, n + 1 entries): the model
// write counts of forced RLE; byte t enters the ring only where
// khat[t + 1] > khat[t].  dict: the initial window, 1 << window bytes.
// A copy of tampn_v1_tables without its probe family.
int tpt_v1_tables(const uint8_t* data, int64_t n, const uint8_t* dict,
                  int window, int literal, int cap, const uint32_t* khat,
                  uint8_t* flen, int32_t* fidx) {
  Committer c;
  c.W = 1 << window; c.wmask = c.W - 1; c.wbits = window; c.literal = literal;
  c.minp = min_pattern_size(window, literal);
  c.maxpat = cap;
  c.lazy = false;
  c.data = data; c.N = n;
  c.full_cap = cap;
  c.ring.assign(dict, dict + c.W);
  c.seed_chains();
  int prev_len = 0, prev_idx = 0;
  for (int64_t t = 0; t < n; t++) {
    int tl = (int)((n - t) < cap ? (n - t) : cap);
    // prefix-property seed: last position's length-L match at slot x gives
    // a valid length L-1 candidate at slot x+1, unless the intervening
    // ring write landed inside it
    int seed_len = prev_len - 1, seed_slot = prev_idx + 1;
    if (seed_len >= c.minp) {
      int w_slot = c.pos == 0 ? c.W - 1 : c.pos - 1;  // last written slot
      if (w_slot >= seed_slot && w_slot < seed_slot + seed_len) seed_len = 0;
    } else {
      seed_len = 0;
    }
    SearchResult r = c.chain_search(data + t, tl, cap, 0, seed_len, seed_slot);
    flen[t] = (uint8_t)(r.size < c.minp ? 0 : r.size);
    fidx[t] = r.idx;
    prev_len = r.size >= c.minp ? r.size : 0;
    prev_idx = r.idx;
    if (!khat || khat[t + 1] > khat[t]) c.ring_push(data[t]);
  }
  return 0;
}

// Minimum-bit v1 parse over exact tables: cost[i] = fewest payload bits to
// encode data[i..n), a literal (where data[i] fits `literal` bits) or a
// match of any size s in [minp, min(flen[i], minp + 13)] at fidx[i].  The
// host reference of the card's optimal v1 encode (kernel X3).  sizes gets
// the tokens' sizes (1 = literal), n_tokens their count.  Returns 0, or -2
// where a byte fits no literal and no match covers it.  A copy of
// tampn_opt_v1_plan.
int tpt_opt_v1_plan(const uint8_t* data, const uint8_t* flen, int64_t n,
                    int window, int literal, uint8_t* sizes,
                    int64_t* n_tokens) {
  const int minp = min_pattern_size(window, literal);
  const int maxpat = minp + 13;
  const uint32_t INF = 0x7FFFFFFFu;
  const uint32_t lit_cost = (uint32_t)(1 + literal);
  const int lit_limit = literal == 8 ? 256 : (1 << literal);
  std::vector<uint32_t> cost((size_t)n + 1);
  std::vector<uint8_t> choice((size_t)n);
  cost[(size_t)n] = 0;
  for (int64_t i = n - 1; i >= 0; i--) {
    uint32_t best = INF;
    uint8_t ch = 0;
    if (data[i] < lit_limit && cost[(size_t)i + 1] < INF) {
      best = cost[(size_t)i + 1] + lit_cost;
      ch = 1;
    }
    int cap = flen[i] < maxpat ? flen[i] : maxpat;
    for (int s = minp; s <= cap; s++) {
      uint32_t below = cost[(size_t)(i + s)];
      if (below >= INF) continue;
      uint32_t c = below + HUFF_BITS[s - minp] + (uint32_t)window;
      if (c < best) { best = c; ch = (uint8_t)s; }
    }
    if (ch == 0) return -2;
    cost[(size_t)i] = best;
    choice[(size_t)i] = ch;
  }
  int64_t t = 0;
  for (int64_t i = 0; i < n; i += choice[(size_t)i]) sizes[t++] = choice[(size_t)i];
  *n_tokens = t;
  return 0;
}

// Expand a per-position choice plane (the card's optimal DP, kernel X4)
// into (sizes, kinds) tokens: advance by choice outside the forced-RLE
// regions runs[2k]..runs[2k+1], and cut each region into RLE chunks by
// the 241/240 rule.  kinds: 0 literal, 1 basic, 2 extended, 3 RLE.
// Returns 0, or -1 on a choice below 1.  A copy of tampn_opt_ext_walk.
int tpt_opt_ext_walk(const uint8_t* choice, int64_t n, int minp,
                     const int64_t* runs, int n_runs, uint8_t* sizes,
                     uint8_t* kinds, int64_t* n_tokens) {
  int wi = 0;
  int64_t t = 0;
  for (int64_t i = 0; i < n;) {
    while (wi < n_runs && runs[2 * wi + 1] <= i) wi++;
    if (wi < n_runs && i >= runs[2 * wi] && i < runs[2 * wi + 1]) {
      const int64_t b = runs[2 * wi + 1];
      while (i < b) {
        int64_t rest = b - i;
        int count = rest >= 243 ? 241 : (rest == 242 ? 240 : (int)rest);
        sizes[t] = (uint8_t)count;
        kinds[t] = 3;
        t++;
        i += count;
      }
      continue;
    }
    int ch = choice[i];
    if (ch < 1) return -1;
    sizes[t] = (uint8_t)ch;
    kinds[t] = ch == 1 ? 0 : (ch <= minp + 11 ? 1 : 2);
    t++;
    i += ch;
  }
  *n_tokens = t;
  return 0;
}

// One-pass host prep of the planned extended encode (the device-commit
// encode's first stage): plans, the (rle_start = s + 1, end) int64 pairs of
// the maximal byte runs >= 9; khat, uint32[n + 1], the kept (window-written)
// bytes among positions < t; dh, the kept byte stream (the model history);
// rc, uint8[dh_len], the forced-RLE chunk's input count (2..241) at each
// chunk's model start, 0 elsewhere.  Chunk rule (left-greedy): c = min(241,
// remn), c-- where it would leave a single trailing byte; keep = min(8, c,
// W - k % W), k the model position at the chunk's start (keeps never wrap
// the ring); a chunk keeps its first `keep` input bytes.  dh and rc hold n
// bytes.  Returns 0, or -1 where plans_cap is too small (n / 9 + 1 always
// suffices).  A copy of tampn_ext_prep; engine/plan.py is its plain
// version.
int tpt_ext_prep(const uint8_t* data, int64_t n, int window, int64_t* plans,
                 int64_t plans_cap, int64_t* n_plans, uint32_t* khat,
                 uint8_t* dh, uint8_t* rc, int64_t* dh_len) {
  const int64_t W = (int64_t)1 << window;
  const int64_t MIN_RUN = 9;
  int64_t np_ = 0, k = 0, t = 0;
  khat[0] = 0;
  while (t < n) {
    const uint8_t b = data[t];
    int64_t e = t + 1;
    while (e < n && data[e] == b) e++;
    if (e - t < MIN_RUN) {  // ordinary bytes: all kept
      for (int64_t p = t; p < e; p++) {
        dh[k] = data[p];
        rc[k] = 0;
        khat[p + 1] = (uint32_t)++k;
      }
      t = e;
      continue;
    }
    // a run >= 9: the byte at t is ordinary (the region starts at t + 1)
    dh[k] = b;
    rc[k] = 0;
    khat[t + 1] = (uint32_t)++k;
    if (np_ >= plans_cap) return -1;
    plans[2 * np_] = t + 1;
    plans[2 * np_ + 1] = e;
    np_++;
    int64_t p = t + 1;
    while (p < e) {
      int64_t remn = e - p;
      int64_t c = remn < RLE_MAX ? remn : RLE_MAX;
      if (remn - c == 1) c--;
      int64_t keep = c < RLE_MAX_WIN ? c : RLE_MAX_WIN;
      int64_t room = W - (k % W);
      if (keep > room) keep = room;  // room >= 1: keep >= 1
      int64_t k0 = k;
      rc[k0] = (uint8_t)c;
      for (int64_t j = 0; j < keep; j++) {
        dh[k] = b;
        if (j) rc[k] = 0;
        k++;
      }
      for (int64_t q = 0; q < c; q++)
        khat[p + q + 1] = (uint32_t)(k0 + (q + 1 < keep ? q + 1 : keep));
      p += c;
    }
    t = e;
  }
  *n_plans = np_;
  *dh_len = k;
  return 0;
}

// Finish a planned extended stream from input position t_in (a walk entry
// of the card's commit kernel, which stops at the first token start >=
// npos - 15, possibly a chunk start inside a forced-RLE region): the
// planned walk with divergence avoidance over data[t_in..n), its bytes
// written after the kernel's bit remainder (acc, an <= 31 bits), the last
// partial byte zero-padded.  dh: the model stream (khat[n] bytes); only its
// last window is replayed into the ring, so no table row is needed.  khat,
// plans/n_plan: as tpt_ext_prep gives them.  dict: the initial window, 1 <<
// window bytes.  Returns 0 ok, -1 output full, -2 a literal wider than
// `literal` bits, -3 a null dict.  A copy of tampn_ext_tail_bits;
// engine/tail.py is its plain version.
int tpt_ext_tail_bits(const uint8_t* data, int64_t n, int64_t t_in,
                      const uint8_t* dh, const uint32_t* khat,
                      const int64_t* plans, int n_plan, const uint8_t* dict,
                      int window, int literal, int lazy, uint32_t acc, int an,
                      uint8_t* out, int64_t out_cap, int64_t* out_len) {
  *out_len = 0;
  if (!dict) return -3;
  Committer c;
  c.W = 1 << window; c.wmask = c.W - 1; c.wbits = window; c.literal = literal;
  c.minp = min_pattern_size(window, literal);
  c.maxpat = c.minp + 131;
  c.lazy = lazy != 0;
  c.avoid_divergence = true;  // the planned model never diverges
  c.data = data; c.N = n;
  c.khat = khat; c.plan = plans; c.n_plan = n_plan;
  c.dh = dh; c.M = (int64_t)khat[n];
  c.full_cap = LOOKAHEAD < c.maxpat ? LOOKAHEAD : c.maxpat;
  c.ring.assign(dict, dict + c.W);
  c.seed_chains();
  // Replay the last K model bytes: the first lands at ring slot 0
  // ((kwr - K) % W == 0; the model puts byte p at slot p % W), the write
  // head ends at kwr % W, and every chain entry left is one the whole walk
  // would also hold (dictionary entries expire iff kwr >= W).
  const int64_t kwr = (int64_t)khat[t_in];
  int64_t K = kwr <= (int64_t)c.W ? kwr : (int64_t)c.W + (kwr & c.wmask);
  if (K) c.ring_push_run(dh + (kwr - K), (int)K);
  c.t = t_in;
  BitWriter bw(out, out_cap);
  if (an > 0) bw.put(acc, an);
  // A resume inside a forced-RLE region is a chunk start (the chunks are
  // left-greedy, so re-cutting from any chunk boundary gives the same
  // chunks); step() fires forced_rle only at a region's start, so finish
  // the region here first.
  while (c.plan_i < n_plan && c.t >= plans[2 * c.plan_i + 1]) c.plan_i++;
  if (c.plan_i < n_plan && c.t > plans[2 * c.plan_i] &&
      c.t < plans[2 * c.plan_i + 1]) {
    int64_t end = plans[2 * c.plan_i + 1];
    c.plan_i++;
    c.bw = &bw;
    c.forced_rle(end);
    if (bw.overflow) { *out_len = bw.n; return -1; }
  }
  int rc = c.run(bw);
  *out_len = bw.n;
  return rc;
}

}  // extern "C"
