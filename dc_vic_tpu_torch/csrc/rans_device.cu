// Interleaved 32-bit rANS on the card: the coder of the "tpu" stream format
// (kernels R1 and R2).
//
// Replaces the device coder of dc_vic_tpu/ops/rans_device.py, which is
// lax.scan over jnp code: R1 is _encode_one + encode_stream + pack_streams
// (with the escape counts the codec's pack tail asks for), R2 is
// decode_section. The byte format is that module's and rans.cpp's
// dcvic_tpu_encode_stream:
//
//   [2L flush words][sec0: renorm words, (step, lane) order | tier-1 | tier-2][sec1 ...]
//
// 32-bit lane states, 16-bit words, 16-bit probabilities, L lanes in
// lockstep sharing one word stream; lane states chain across the sections of
// a stream, which are encoded last to first. An escape takes its row's last
// bin in the rANS stream and its zigzag payload in the side channel: one
// tier-1 word (the payload, or 0xFFFF), then two tier-2 words if marked.
//
// Both kernels read and write the model's NCHW planes. Stream position p of
// a section [sc, H, W] is the NHWC flatten, p = (h * W + w) * sc + c; step
// p / L, lane p % L.
//
// What bounds them on Hopper: neither bytes nor arithmetic (a stream is a few
// hundred KB; a symbol costs a few dozen integer operations) but the
// dependent chain. A lane's state at step t needs its state at step t - 1;
// in the decoder the table lookups need the state and the next word's
// address needs the whole step's renormalisation count. A section of n steps
// costs n times the latency of one step, so the designs keep every other
// piece of work off that chain: R1 moves it into launches that spread an
// image over many SMs, R2 keeps all but one of its lookups in shared memory.
//
// R1 (encode + pack): four launches on the caller's stream, no host wait.
// Positions come from counts and scans, never from an atomic counter, so the
// bytes do not depend on timing. One lane group is 32 lanes of one step
// (fewer when L < 32); `entries` = steps x groups, in stream order.
//   E0 symbols (whole grid, a warp per lane group): each symbol's packed
//      (start, freq) in stream order into `rec`, and ballot masks of the
//      group's escapes and tier-2 escapes.
//   E1 states (a thread per lane, 64 lanes a block, so an image spreads over
//      L / 64 SMs): the recurrence, last step to first. Its input is a
//      coalesced stream that does not depend on the state, so eight steps are
//      in flight while the chain (renormalise, divide) runs; the chain is the
//      32-bit division alone. Each renorm word overwrites its own `rec`
//      entry; a ballot per step gives the group's renorm mask. The final
//      states are the flush.
//   E2 scan (a block per image): popcounts of the three masks, exclusive
//      prefix over all groups in stream order; the totals give counts,
//      esc_counts and big_counts.
//   E3 scatter (whole grid, a warp per lane group): every word to its
//      section's block at prefix + ballot rank; an escape's payload is
//      recomputed from its symbol.
//
// R2 (decode): one block per image, one lane per thread (rounds of 1024
// lanes beyond 1024). Per step: cum = x & 0xFFFF; bin = lut[row][cum] (a
// 2^16-entry uint16 table per CDF row, read through L2 only); (start, freq)
// from the pair table; x = freq * (x >> 16) + cum - start. Lanes with
// x < 2^16 read the next words in lane order: the rank is a warp ballot and
// popc, and the warps' counts meet in one exchange a step: lane 0 of each
// warp stores its counts (renorm | escapes << 16) in shared memory, one
// barrier, then lane w of every warp reads warp w's count and two warp
// reductions give the earlier warps' prefix and the step's total (two
// alternating slots, so no second barrier). The next step's CDF row and
// address advance by adds, with no division in the loop, and are fetched
// while the step runs. Of the three dependent lookups only the LUT's goes
// to L2: the pair table's valid bins (106 KB for the 64 Gaussian rows) are
// copied into shared memory once (cp.async), and the next 2T words of the
// stream wait in a shared ring whose freed slots are refilled a round
// later, from loads issued as the round ends. A table of more than
// kMaxPacked bins (a factorised table with wide quantiles) stays in global
// memory, read through L1: the same kernel, instantiated for that source. Escapes are rare: their
// positions are appended to a list during the scan (ranked by the same
// ballots) and resolved after it from the side channel, tier-2 ranks by the
// same exchange over the list. A violated header guarantee adds kEscPoison
// to the cursor. Reads outside the word buffer give 0, never a fault.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kTier1Marker = 0xFFFFu;
constexpr int kEscPoison = 1 << 26;
constexpr int kMaxLanes = 4096;
constexpr int kMaxThreads = 1024;     // R2's block: one lane per thread and round
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxPacked = 44 * 1024;   // pair entries R2 copies to shared memory (176 KB);
                                        // a larger table is read from global memory
constexpr int kGroupWarps = 8;        // lane groups per block of E0 and E3
constexpr int kStateThreads = 64;     // lanes per block of E1
constexpr int kInFlight = 8;          // steps of E1's input loaded ahead
constexpr int kScanThreads = 1024;    // E2
constexpr int kScanWarps = kScanThreads / 32;

constexpr uint32_t kEscape = 1u << 17;   // EncSymbol flags
constexpr uint32_t kBig = 1u << 18;

enum DecodeFlags { kEscFree = 1, kTier2 = 2, kSparseEsc = 4, kOutInt16 = 8 };

struct Tables {
  const uint32_t* pair;   // [rows * cols] start | freq << 16
  const int* offsets;     // [rows]
  const int* maxv;        // [rows]
  int rows, cols;
};

__device__ __forceinline__ int clamp_row(int row, int rows) {
  return row < 0 ? 0 : (row >= rows ? rows - 1 : row);
}

// Address of stream position p of a section whose channel 0 is plane
// `first_plane` of the NCHW tensor, and its channel within the section.
__device__ __forceinline__ size_t plane_addr(size_t first_plane, int p, int sc, int HW, int* c) {
  *c = p % sc;
  return (first_plane + *c) * HW + p / sc;
}

// (start | freq << 16, flags, payload) of one symbol for the encoder.
struct EncSymbol {
  uint32_t pair, flags, raw;
};

// Symbol planes are int16 (the model's) or int32 (`wide`).
struct SymbolPlanes {
  const void* data;
  int wide;
  __device__ __forceinline__ int at(size_t a) const {
    return wide ? static_cast<const int32_t*>(data)[a]
                : static_cast<int>(static_cast<const int16_t*>(data)[a]);
  }
};

__device__ __forceinline__ EncSymbol enc_symbol(const SymbolPlanes& sym, const uint8_t* idx,
                                                const Tables& t, size_t first_plane,
                                                int first_channel, int p, int sc, int HW) {
  int c;
  const size_t a = plane_addr(first_plane, p, sc, HW, &c);
  const int row = clamp_row(idx ? idx[a] : first_channel + c, t.rows);
  const int mv = t.maxv[row];
  long long value = static_cast<long long>(sym.at(a)) - t.offsets[row];
  EncSymbol out;
  out.flags = 0;
  out.raw = 0;
  if (value < 0 || value >= mv) {
    out.raw = value < 0 ? static_cast<uint32_t>(-2 * value - 1)      // fits for any int32
                        : static_cast<uint32_t>(2 * (value - mv));
    out.flags = kEscape | (out.raw >= kTier1Marker ? kBig : 0u);
    value = mv;
  }
  long long at = static_cast<long long>(row) * t.cols + value;
  const long long last = static_cast<long long>(t.rows) * t.cols - 1;
  at = at < 0 ? 0 : (at > last ? last : at);
  out.pair = t.pair[at];
  return out;
}

// One image's stream for R1: S sections of sc channels, n steps of L lanes
// each; `groups` lane groups a step, `entries` = S * n * groups.
struct EncGeom {
  int C, HW, S, sc, L, n, steps, groups, entries;
  size_t N;   // symbols per image
};

// The lane group of warp `e` of E0/E3: its step, section and first lane.
struct Group {
  int step, s, l0;
};

__device__ __forceinline__ Group group_of(const EncGeom& g, int e) {
  Group q;
  q.step = e / g.groups;
  q.s = q.step / g.n;
  q.l0 = (e - q.step * g.groups) * 32;
  return q;
}

// E0: (start, freq) of every symbol in stream order; masks [3][entries]
// per image: plane 1 escapes, plane 2 tier-2 escapes (plane 0 is E1's).
__global__ void __launch_bounds__(kGroupWarps * 32)
rans_encode_symbols_kernel(SymbolPlanes sym, const uint8_t* __restrict__ idx, Tables t,
                           EncGeom g, uint32_t* __restrict__ rec,
                           uint32_t* __restrict__ masks) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kGroupWarps + (threadIdx.x >> 5);
  if (e >= g.entries) return;                     // whole warps
  const Group q = group_of(g, e);
  const int l = q.l0 + lane;
  EncSymbol es{0u, 0u, 0u};
  if (l < g.L) {
    es = enc_symbol(sym, idx, t, static_cast<size_t>(b) * g.C + static_cast<size_t>(q.s) * g.sc,
                    q.s * g.sc, (q.step - q.s * g.n) * g.L + l, g.sc, g.HW);
    rec[static_cast<size_t>(b) * g.N + static_cast<size_t>(q.step) * g.L + l] = es.pair;
  }
  const uint32_t em = __ballot_sync(0xFFFFFFFFu, es.flags & kEscape);
  const uint32_t bm = __ballot_sync(0xFFFFFFFFu, es.flags & kBig);
  if (lane == 0) {
    uint32_t* m = masks + static_cast<size_t>(b) * 3 * g.entries;
    m[g.entries + e] = em;
    m[2 * g.entries + e] = bm;
  }
}

// E1: the state recurrence, a thread per lane, last step to first. Renorm
// words overwrite their own rec entry; plane 0 of masks gets the renorm
// ballots; the final states are the 2L flush words.
__global__ void __launch_bounds__(kStateThreads)
rans_encode_states_kernel(EncGeom g, uint32_t* __restrict__ rec, uint32_t* __restrict__ masks,
                          uint16_t* __restrict__ out, int cap) {
  const int b = blockIdx.y;
  const int l = blockIdx.x * kStateThreads + threadIdx.x;
  const int w = l >> 5, lane = threadIdx.x & 31;
  if (w * 32 >= g.L) return;                     // warps wholly past the lanes
  const bool active = l < g.L;
  uint32_t* r = rec + static_cast<size_t>(b) * g.N + (active ? l : 0);
  uint32_t* rm = masks + static_cast<size_t>(b) * 3 * g.entries + w;
  const size_t stride = g.L;
  uint32_t x = kRansL;
  uint32_t in[kInFlight];
  int top = g.steps - 1;
#pragma unroll
  for (int u = 0; u < kInFlight; ++u)
    in[u] = (active && top - u >= 0) ? r[(top - u) * stride] : kRansL;
  for (; top >= 0; top -= kInFlight) {
    uint32_t ahead[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int s = top - kInFlight - u;
      ahead[u] = (active && s >= 0) ? r[s * stride] : kRansL;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int s = top - u;
      if (s < 0) break;                          // the same for the whole warp
      const uint32_t start = in[u] & 0xFFFFu, freq = in[u] >> 16;
      const bool renorm = active && x >= (freq << 16);
      if (renorm) {
        r[s * stride] = x & 0xFFFFu;
        x >>= 16;
      }
      x = ((x / freq) << 16) | (x % freq + start);
      const uint32_t m = __ballot_sync(0xFFFFFFFFu, renorm);
      if (lane == 0) rm[static_cast<size_t>(s) * g.groups] = m;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) in[u] = ahead[u];
  }
  if (active) {
    uint16_t* o = out + static_cast<size_t>(b) * cap;
    o[2 * l] = static_cast<uint16_t>(x & 0xFFFFu);
    o[2 * l + 1] = static_cast<uint16_t>(x >> 16);
  }
}

// Exclusive prefix of v over the block's threads and the block's total, for
// three counters at once. `warp_tot` is shared [3][kScanWarps].
__device__ __forceinline__ void block_scan3(int v[3], int excl[3], int total[3],
                                            int (*warp_tot)[kScanWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int x = v[k];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane >= d) x += y;
    }
    incl[k] = x;
    if (lane == 31) warp_tot[k][warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int before = 0, all = 0;
    for (int w = 0; w < kScanWarps; ++w) {
      const int c = warp_tot[k][w];
      if (w < warp) before += c;
      all += c;
    }
    excl[k] = before + incl[k] - v[k];
    total[k] = all;
  }
}

// E2: prefix [3][entries + 1] per image (renorm words, escapes, tier-2
// escapes before each lane group; totals at [entries]).
__global__ void __launch_bounds__(kScanThreads)
rans_encode_scan_kernel(EncGeom g, const uint32_t* __restrict__ masks, int* __restrict__ prefix,
                        int* __restrict__ counts, int* __restrict__ esc_counts,
                        int* __restrict__ big_counts) {
  __shared__ int warp_tot[3][kScanWarps];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int E = g.entries;
  const uint32_t* m = masks + static_cast<size_t>(b) * 3 * E;
  int* P = prefix + static_cast<size_t>(b) * 3 * (E + 1);
  const int chunk = (E + kScanThreads - 1) / kScanThreads;
  const int lo = min(E, tid * chunk), hi = min(E, lo + chunk);
  int v[3] = {0, 0, 0}, excl[3], total[3];
  for (int e = lo; e < hi; ++e)
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] += __popc(m[k * E + e]);
  block_scan3(v, excl, total, warp_tot);
  for (int e = lo; e < hi; ++e)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      P[k * (E + 1) + e] = excl[k];
      excl[k] += __popc(m[k * E + e]);
    }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) P[k * (E + 1) + E] = total[k];
    counts[b] = 2 * g.L + total[0] + total[1] + 2 * total[2];
    big_counts[b] = total[2];
  }
  __syncthreads();
  const int per_section = g.n * g.groups;
  for (int s = tid; s < g.S; s += kScanThreads)
    esc_counts[static_cast<size_t>(b) * g.S + s] =
        P[(E + 1) + (s + 1) * per_section] - P[(E + 1) + s * per_section];
}

// E3: every word to its position.
__global__ void __launch_bounds__(kGroupWarps * 32)
rans_encode_scatter_kernel(SymbolPlanes sym, const uint8_t* __restrict__ idx, Tables t,
                           EncGeom g, const uint32_t* __restrict__ rec,
                           const uint32_t* __restrict__ masks, const int* __restrict__ prefix,
                           uint16_t* __restrict__ out, int cap) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int e = blockIdx.x * kGroupWarps + (threadIdx.x >> 5);
  if (e >= g.entries) return;
  const int E = g.entries;
  const Group q = group_of(g, e);
  const uint32_t* m = masks + static_cast<size_t>(b) * 3 * E;
  const int* P0 = prefix + static_cast<size_t>(b) * 3 * (E + 1);
  const int* P1 = P0 + (E + 1);
  const int* P2 = P1 + (E + 1);
  const int e0 = q.s * g.n * g.groups, e1 = e0 + g.n * g.groups;   // the section's groups
  const int R0 = P0[e0], E0 = P1[e0], G0 = P2[e0];
  const int base = 2 * g.L + R0 + E0 + 2 * G0;
  const int Rs = P0[e1] - R0, Es = P1[e1] - E0;
  const uint32_t rm = m[e], em = m[E + e], bm = m[2 * E + e];
  const uint32_t bit = 1u << lane, lt = bit - 1u;
  const int l = q.l0 + lane;
  uint16_t* o = out + static_cast<size_t>(b) * cap;
  if (rm & bit)
    o[base + (P0[e] - R0) + __popc(rm & lt)] = static_cast<uint16_t>(
        rec[static_cast<size_t>(b) * g.N + static_cast<size_t>(q.step) * g.L + l] & 0xFFFFu);
  if (em & bit) {
    const EncSymbol es = enc_symbol(
        sym, idx, t, static_cast<size_t>(b) * g.C + static_cast<size_t>(q.s) * g.sc,
        q.s * g.sc, (q.step - q.s * g.n) * g.L + l, g.sc, g.HW);
    const bool big = bm & bit;
    o[base + Rs + (P1[e] - E0) + __popc(em & lt)] =
        static_cast<uint16_t>(big ? kTier1Marker : es.raw);
    if (big) {
      const int w2 = base + Rs + Es + 2 * (P2[e] - G0) + 2 * __popc(bm & lt);
      o[w2] = static_cast<uint16_t>(es.raw & 0xFFFFu);
      o[w2 + 1] = static_cast<uint16_t>(es.raw >> 16);
    }
  }
}

// A word of the buffer, 0 outside it.
__device__ __forceinline__ uint32_t read_word(const uint16_t* words, long long n_words,
                                              long long at) {
  return (at >= 0 && at < n_words) ? __ldg(words + at) : 0u;
}

// 16 bytes from global to shared memory without a register; complete
// after cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The exclusive prefix and the total over the block's warps of one count
// per warp (lane 0's `mine`), through `slot` [kMaxWarps]: one barrier, one
// shared read per lane and two warp reductions.
__device__ __forceinline__ void warp_exchange(uint32_t mine, uint32_t* slot, uint32_t* before,
                                              uint32_t* all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) slot[warp] = mine;
  __syncthreads();
  const uint32_t c = lane < (blockDim.x >> 5) ? slot[lane] : 0u;
  *before = __reduce_add_sync(0xFFFFFFFFu, lane < warp ? c : 0u);
  *all = __reduce_add_sync(0xFFFFFFFFu, c);
}

// R2. A block of T = min(L, 1024) threads (one warp below 32 lanes) per
// image, one lane per thread and round; a step is L / T rounds. The pair
// table's valid bins (`packed`, row r's from packed_base[r]) are copied into
// dynamic shared memory first (kSharedPairs), or read where they are.
template <bool kSharedPairs>
__global__ void __launch_bounds__(kMaxThreads)
rans_decode_section_kernel(const uint16_t* __restrict__ words, long long n_words,
                           const int* __restrict__ img_base, const int* __restrict__ cursor_in,
                           const uint32_t* __restrict__ state_in,
                           const uint8_t* __restrict__ idx, const uint16_t* __restrict__ lut,
                           Tables t, const uint32_t* __restrict__ packed,
                           const int* __restrict__ packed_base, int packed_n, int sc, int HW,
                           int L, int flags, int esc_cap, int* __restrict__ esc_pos,
                           void* __restrict__ out, int* __restrict__ cursor_out,
                           uint32_t* __restrict__ state_out) {
  extern __shared__ uint4 spair4[];               // the packed pair table
  __shared__ uint32_t xs[kMaxLanes];              // lane states between rounds
  __shared__ uint32_t warp_cnt[2][kMaxWarps];     // renorm count | escape count << 16
  __shared__ uint16_t ring[2 * kMaxThreads];      // the words ahead of the cursor
  const int b = blockIdx.x, tid = threadIdx.x;
  const int T = blockDim.x;
  const uint32_t lt = (1u << (tid & 31)) - 1u;
  const int n_sym = sc * HW;
  const int rounds = L > T ? L / T : 1;
  const int adv = L < T ? L : T;                  // positions from one round to the next
  const int iters = (n_sym / L) * rounds;
  const bool on = tid < L;                        // off only in a partial warp
  const long long base = img_base[b];
  const size_t img = static_cast<size_t>(b) * n_sym;
  const uint8_t* ix = idx ? idx + img : nullptr;
  int16_t* out16 = static_cast<int16_t*>(out) + img;
  int32_t* out32 = static_cast<int32_t*>(out) + img;
  const bool o16 = flags & kOutInt16;
  esc_pos += img;
  long long cur = cursor_in[b];

  if (kSharedPairs)
    for (int k = tid; 4 * k < packed_n; k += T) cp_async16(spair4 + k, packed + 4 * k);
  const uint32_t* spair = reinterpret_cast<const uint32_t*>(spair4);
  // the lane states: the previous section's, or the stream's flush words
  for (int l = tid; l < L; l += T)
    xs[l] = state_in ? state_in[static_cast<size_t>(b) * L + l]
                     : read_word(words, n_words, base + cur + 2 * l) |
                           (read_word(words, n_words, base + cur + 2 * l + 1) << 16);
  if (!state_in) cur += 2 * L;
  // The ring holds the 2T words from the cursor on: a round reads at most T
  // of them, and the T slots it frees are refilled a round later, after the
  // next round's barrier, from loads issued as it ends.
  const int ring_mask = 2 * T - 1;
  for (int k = tid; k < 2 * T; k += T) {
    const long long q = base + cur + k;
    ring[q & ring_mask] = static_cast<uint16_t>(read_word(words, n_words, q));
  }
  cp_async_wait_all();
  __syncthreads();
  uint32_t x = on ? xs[tid] : 0u;

  // The thread's position advances by `adv` each iteration: its channel by
  // adv_m (wrapping at sc), its address within the image by step_a.
  const int adv_q = adv / sc, adv_m = adv - adv_q * sc;
  const int step_a = adv_m * HW + adv_q, wrap_a = 1 - sc * HW;
  int c = tid % sc;
  int a = c * HW + tid / sc;
  int row = clamp_row(on && iters > 0 ? (ix ? ix[a] : c) : 0, t.rows);

  int n_esc = 0, buf = 0, r = 0;
  long long pend_q = 0;                           // a word loaded for the ring
  uint32_t pend_w = 0;
  bool pend = false;
  for (int it = 0; it < iters; ++it) {
    if (rounds > 1) x = xs[r * T + tid];
    const int rw = row, here = a;
    const int mv = __ldg(t.maxv + rw), off = __ldg(t.offsets + rw);
    const int pb = __ldg(packed_base + rw);
    c += adv_m;                                   // the next iteration's address and row
    a += step_a;
    if (c >= sc) {
      c -= sc;
      a += wrap_a;
    }
    if (on && it + 1 < iters) row = clamp_row(ix ? ix[a] : c, t.rows);

    const uint32_t cum = x & 0xFFFFu;
    const int bin = __ldcg(lut + (static_cast<size_t>(rw) << 16) + cum);
    const uint32_t pr = kSharedPairs ? spair[pb + bin] : __ldg(packed + pb + bin);
    x = (pr >> 16) * (x >> 16) + cum - (pr & 0xFFFFu);
    const bool need = on && x < kRansL, esc = on && bin == mv;
    if (on) {
      if (o16) out16[here] = static_cast<int16_t>(bin + off);
      else out32[here] = bin + off;
    }
    const uint32_t bn = __ballot_sync(0xFFFFFFFFu, need);
    const uint32_t be = __ballot_sync(0xFFFFFFFFu, esc);
    uint32_t before, all;
    warp_exchange(__popc(bn) | (__popc(be) << 16), warp_cnt[buf], &before, &all);
    if (pend) ring[pend_q & ring_mask] = static_cast<uint16_t>(pend_w);
    if (need)
      x = (x << 16) | ring[(base + cur + (before & 0xFFFFu) + __popc(bn & lt)) & ring_mask];
    if (esc) esc_pos[n_esc + (before >> 16) + __popc(be & lt)] = it * adv + tid;
    pend = tid < static_cast<int>(all & 0xFFFFu);   // the slots this round frees
    pend_q = base + cur + 2 * T + tid;
    pend_w = 0;                                   // a predicated load: no wait here
    if (pend && pend_q >= 0 && pend_q < n_words) pend_w = __ldg(words + pend_q);
    cur += all & 0xFFFFu;
    n_esc += all >> 16;
    buf ^= 1;
    if (rounds > 1) {
      xs[r * T + tid] = x;
      if (++r == rounds) r = 0;
    }
  }
  if (rounds == 1 && on) xs[tid] = x;
  __syncthreads();                                // esc_pos and xs are complete
  for (int l = tid; l < L; l += T) state_out[static_cast<size_t>(b) * L + l] = xs[l];

  long long poison = 0;
  if (flags & kEscFree) {
    // escaped positions keep the escape bin's value; the stream broke its word
    if (n_esc > 0) poison = kEscPoison;
  } else {
    // the side channel: tier-1 words at cur, tier-2 pairs behind them
    const long long t1 = base + cur, t2 = t1 + n_esc;
    int n_big = 0;
    for (int e0 = 0; e0 < n_esc; e0 += T) {
      const int e = e0 + tid;
      const bool act = e < n_esc;
      const uint32_t w1 = act ? read_word(words, n_words, t1 + e) : 0u;
      const bool big = act && w1 == kTier1Marker;
      const uint32_t bb = __ballot_sync(0xFFFFFFFFu, big);
      uint32_t before, all;
      warp_exchange(__popc(bb), warp_cnt[buf], &before, &all);
      if (act) {
        uint32_t raw = w1;
        if (big && (flags & kTier2)) {
          const long long q = t2 + 2ll * (n_big + before + __popc(bb & lt));
          raw = read_word(words, n_words, q) | (read_word(words, n_words, q + 1) << 16);
        }
        const int p = esc_pos[e];
        const int ch = p % sc;
        const size_t ea = static_cast<size_t>(ch) * HW + p / sc;
        const int er = clamp_row(ix ? ix[ea] : ch, t.rows);
        const int v = (raw & 1u) ? -static_cast<int>(raw >> 1) - 1
                                 : static_cast<int>(raw >> 1) + t.maxv[er];
        const int value = v + t.offsets[er];
        if (o16) out16[ea] = static_cast<int16_t>(value);
        else out32[ea] = value;
      }
      n_big += all;
      buf ^= 1;
    }
    cur += n_esc;
    if (flags & kTier2) cur += 2ll * n_big;
    else if (n_big > 0) poison = kEscPoison;
    if ((flags & kSparseEsc) && n_esc > esc_cap) poison += kEscPoison;
  }
  if (tid == 0) cursor_out[b] = static_cast<int>(cur + poison);
}

}  // namespace

// R1. sym [B, C, HW] int16 (int32 with sym_wide) and idx [B, C, HW] uint8
// (or null: CDF row = channel), S sections of C / S channels each, L lanes
// (a power of two dividing C / S * HW). With n = C / S * HW / L steps a
// section and groups = max(1, L / 32) lane groups a step, entries = S * n *
// groups. Scratch: rec [B, C * HW] uint32, masks [B, 3, entries] uint32,
// prefix [B, 3, entries + 1] int32. Out: words [B, cap] with cap >= 2L + 4 *
// C * HW, counts [B], esc_counts [B, S], big_counts [B]. Returns the
// cudaError_t of the first launch that failed (0 on success).
extern "C" int dcvic_rans_encode_pack(const void* sym, int sym_wide, const void* idx,
                                      const void* pair, const void* offsets, const void* maxv,
                                      int rows, int cols, int B, int C, int HW, int S, int L,
                                      void* rec, void* masks, void* prefix, int entries,
                                      void* out, int cap, void* counts, void* esc_counts,
                                      void* big_counts, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || HW <= 0 || S <= 0 || C % S || L <= 0 || L > kMaxLanes ||
      (L & (L - 1)) || (static_cast<long long>(C / S) * HW) % L ||
      cap < 2 * L + 4ll * C * HW)
    return static_cast<int>(cudaErrorInvalidValue);
  EncGeom g;
  g.C = C;
  g.HW = HW;
  g.S = S;
  g.sc = C / S;
  g.L = L;
  g.n = static_cast<int>(static_cast<long long>(g.sc) * HW / L);
  g.steps = S * g.n;
  g.groups = L < 32 ? 1 : L / 32;
  g.N = static_cast<size_t>(C) * HW;
  if (static_cast<long long>(g.steps) * g.groups != entries)
    return static_cast<int>(cudaErrorInvalidValue);
  g.entries = entries;
  const Tables t{static_cast<const uint32_t*>(pair), static_cast<const int*>(offsets),
                 static_cast<const int*>(maxv), rows, cols};
  const SymbolPlanes planes{sym, sym_wide};
  const uint8_t* ix = static_cast<const uint8_t*>(idx);
  uint32_t* r = static_cast<uint32_t*>(rec);
  uint32_t* m = static_cast<uint32_t*>(masks);
  int* p = static_cast<int*>(prefix);
  uint16_t* o = static_cast<uint16_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 per_group((entries + kGroupWarps - 1) / kGroupWarps, B);
  rans_encode_symbols_kernel<<<per_group, kGroupWarps * 32, 0, st>>>(planes, ix, t, g, r, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rans_encode_states_kernel<<<dim3((L + kStateThreads - 1) / kStateThreads, B), kStateThreads, 0,
                              st>>>(g, r, m, o, cap);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  rans_encode_scan_kernel<<<B, kScanThreads, 0, st>>>(g, m, p, static_cast<int*>(counts),
                                                      static_cast<int*>(esc_counts),
                                                      static_cast<int*>(big_counts));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  rans_encode_scatter_kernel<<<per_group, kGroupWarps * 32, 0, st>>>(planes, ix, t, g, r, m, p,
                                                                     o, cap);
  return static_cast<int>(cudaGetLastError());
}

// R2. One section [B, sc, HW] of every image's stream. words: all streams
// back to back; img_base, cursor_in [B]; state_in [B, L] or null for a
// stream's first section; idx [B, sc, HW] uint8 or null (CDF row = channel);
// lut [rows, 65536] uint16; packed [packed_n] uint32 (a multiple of 4) and
// packed_base [rows]: the pair table's valid bins back to back, which the
// kernel copies into shared memory when there are at most kMaxPacked.
// Scratch esc_pos [B, sc * HW] int32. Out: symbols [B, sc, HW] int16 (flag 8)
// or int32, cursor_out [B], state_out [B, L]. flags: 1 escape-free
// guarantee, 2 resolve tier 2, 4 hold to esc_cap, 8 int16 output. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int dcvic_rans_decode_section(const void* words, long long n_words,
                                         const void* img_base, const void* cursor_in,
                                         const void* state_in, const void* idx,
                                         const void* lut, const void* pair,
                                         const void* offsets, const void* maxv,
                                         const void* packed, const void* packed_base,
                                         int packed_n, int rows, int cols, int B, int sc,
                                         int HW, int L, int flags, int esc_cap, void* esc_pos, void* out,
                                         void* cursor_out, void* state_out, void* stream) {
  if (B <= 0 || sc <= 0 || HW <= 0 || L <= 0 || L > kMaxLanes || (L & (L - 1)) ||
      (static_cast<long long>(sc) * HW) % L || static_cast<long long>(sc) * HW > (1ll << 30) ||
      packed_n <= 0 || packed_n % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{static_cast<const uint32_t*>(pair), static_cast<const int*>(offsets),
                 static_cast<const int*>(maxv), rows, cols};
  const int threads = L < 32 ? 32 : (L > kMaxThreads ? kMaxThreads : L);
  const bool shared_pairs = packed_n <= kMaxPacked;
  const auto kernel =
      shared_pairs ? rans_decode_section_kernel<true> : rans_decode_section_kernel<false>;
  const size_t smem = shared_pairs ? static_cast<size_t>(packed_n) * sizeof(uint32_t) : 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(words), n_words, static_cast<const int*>(img_base),
      static_cast<const int*>(cursor_in), static_cast<const uint32_t*>(state_in),
      static_cast<const uint8_t*>(idx), static_cast<const uint16_t*>(lut), t,
      static_cast<const uint32_t*>(packed), static_cast<const int*>(packed_base), packed_n, sc,
      HW, L, flags, esc_cap, static_cast<int*>(esc_pos), out, static_cast<int*>(cursor_out),
      static_cast<uint32_t*>(state_out));
  return static_cast<int>(cudaGetLastError());
}
