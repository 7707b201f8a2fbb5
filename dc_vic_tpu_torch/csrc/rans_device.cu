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
// hundred KB; a symbol costs a dozen integer operations) but the dependent
// chain. A lane's state at step t needs its state at step t - 1, and in the
// decoder the table lookup needs the state and the next word's address needs
// the whole step's renormalisation count. So a section of n steps costs n
// times the latency of one step, whatever the width.
//
// Design, one block per image in both kernels:
//
// R2 (decode): one thread per lane (lanes beyond the block width in rounds).
// Per step: cum = x & 0xFFFF; bin = lut[row][cum] (a 2^16-entry uint16 table
// per CDF row; 8 MB for the 64 Gaussian rows, inside L2); (start, freq) from
// the packed pair table; x = freq * (x >> 16) + cum - start. Lanes with
// x < 2^16 read the next words in lane order: the rank is a warp ballot and
// popc, the warps' counts meet in shared memory (renorm count and escape
// count packed in one word), one barrier per step, two alternating count
// buffers so that no second barrier is needed. The CDF row of the next step
// is fetched while this step computes. Escapes are rare: their positions
// are appended to a list during the scan (ranked by the same ballots) and
// resolved after it from the side channel, tier-2 ranks by the same block
// scan over the list. A violated header guarantee adds kEscPoison to the
// cursor. Reads outside the word buffer give 0, never a fault.
//
// R1 (encode + pack), four phases with a barrier between them:
//   1. The state recurrence, one thread per lane, last step to first. It is
//      independent per lane, so there is no barrier in the loop; the next
//      symbol's (start, freq) is fetched before the 32-bit division of the
//      current one. Each symbol's word and flags (renorm, escape, tier-2)
//      go to a scratch record in stream order; the final states are the
//      flush.
//   2. A warp per step counts the step's renorm words, escapes and tier-2
//      escapes (ballots over the records).
//   3. A block-wide exclusive scan of the three counts over all steps.
//      Every output position follows from these prefixes and a ballot rank:
//      positions come from counts and scans, never from an atomic counter,
//      so the bytes do not depend on timing.
//   4. A warp per step writes the words to their positions; an escape's
//      payload is recomputed from its symbol.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kTier1Marker = 0xFFFFu;
constexpr int kEscPoison = 1 << 26;
constexpr int kLutSize = 1 << 16;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

constexpr uint32_t kRenorm = 1u << 16;   // record flags
constexpr uint32_t kEscape = 1u << 17;
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

// Exclusive prefix of v over the block's threads and the block's total, for
// three counters at once. `warp_tot` is shared [3][kMaxWarps]. Ends with no
// barrier pending: callers barrier before reusing warp_tot.
__device__ __forceinline__ void block_scan3(int v[3], int excl[3], int total[3],
                                            int (*warp_tot)[kMaxWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
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
    for (int w = 0; w < nwarps; ++w) {
      const int c = warp_tot[k][w];
      if (w < warp) before += c;
      all += c;
    }
    excl[k] = before + incl[k] - v[k];
    total[k] = all;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
rans_encode_pack_kernel(SymbolPlanes sym, const uint8_t* __restrict__ idx,
                        Tables t, int C, int HW, int S, int L,
                        uint32_t* __restrict__ rec, int* __restrict__ prefix,
                        uint16_t* __restrict__ out, int cap, int* __restrict__ counts,
                        int* __restrict__ esc_counts, int* __restrict__ big_counts) {
  __shared__ int warp_tot[3][kMaxWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sc = C / S;
  const int n = static_cast<int>(static_cast<long long>(sc) * HW / L);   // steps per section
  const int steps = S * n;
  const size_t N = static_cast<size_t>(C) * HW;
  rec += b * N;
  out += static_cast<size_t>(b) * cap;
  int* P0 = prefix + static_cast<size_t>(b) * 3 * (steps + 1);
  int* P1 = P0 + (steps + 1);
  int* P2 = P1 + (steps + 1);
  const size_t plane0 = static_cast<size_t>(b) * C;

  // phase 1: the state recurrence, one lane per thread
  for (int l = tid; l < L; l += blockDim.x) {
    uint32_t x = kRansL;
    int g = steps - 1;
    EncSymbol next = enc_symbol(sym, idx, t, plane0 + static_cast<size_t>(g / n) * sc,
                                (g / n) * sc, (g % n) * L + l, sc, HW);
    for (; g >= 0; --g) {
      const EncSymbol cur = next;
      if (g > 0) {
        const int s = (g - 1) / n;
        next = enc_symbol(sym, idx, t, plane0 + static_cast<size_t>(s) * sc, s * sc,
                          ((g - 1) % n) * L + l, sc, HW);
      }
      const uint32_t start = cur.pair & 0xFFFFu, freq = cur.pair >> 16;
      uint32_t r = (x & 0xFFFFu) | cur.flags;
      if (x >= (freq << 16)) {
        r |= kRenorm;
        x >>= 16;
      }
      rec[static_cast<size_t>(g) * L + l] = r;
      x = ((x / freq) << 16) | (x % freq + start);
    }
    out[2 * l] = static_cast<uint16_t>(x & 0xFFFFu);
    out[2 * l + 1] = static_cast<uint16_t>(x >> 16);
  }
  __syncthreads();

  // phase 2: per-step counts of renorm words, escapes, tier-2 escapes
  for (int g = warp; g < steps; g += nwarps) {
    int cr = 0, ce = 0, cg = 0;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const uint32_t r = l0 + lane < L ? rec[static_cast<size_t>(g) * L + l0 + lane] : 0u;
      cr += __popc(__ballot_sync(0xFFFFFFFFu, r & kRenorm));
      ce += __popc(__ballot_sync(0xFFFFFFFFu, r & kEscape));
      cg += __popc(__ballot_sync(0xFFFFFFFFu, r & kBig));
    }
    if (lane == 0) {
      P0[g] = cr;
      P1[g] = ce;
      P2[g] = cg;
    }
  }
  __syncthreads();

  // phase 3: exclusive scan over the steps, in place; totals at [steps]
  {
    const int chunk = (steps + blockDim.x - 1) / blockDim.x;
    const int lo = min(steps, tid * chunk), hi = min(steps, lo + chunk);
    int v[3] = {0, 0, 0}, excl[3], total[3];
    for (int g = lo; g < hi; ++g) {
      v[0] += P0[g];
      v[1] += P1[g];
      v[2] += P2[g];
    }
    block_scan3(v, excl, total, warp_tot);
    for (int g = lo; g < hi; ++g) {
      const int c0 = P0[g], c1 = P1[g], c2 = P2[g];
      P0[g] = excl[0];
      P1[g] = excl[1];
      P2[g] = excl[2];
      excl[0] += c0;
      excl[1] += c1;
      excl[2] += c2;
    }
    if (tid == 0) {
      P0[steps] = total[0];
      P1[steps] = total[1];
      P2[steps] = total[2];
      counts[b] = 2 * L + total[0] + total[1] + 2 * total[2];
      big_counts[b] = total[2];
    }
  }
  __syncthreads();
  for (int s = tid; s < S; s += blockDim.x)
    esc_counts[static_cast<size_t>(b) * S + s] = P1[(s + 1) * n] - P1[s * n];

  // phase 4: every word to its position
  const uint32_t lt = (1u << lane) - 1u;
  for (int g = warp; g < steps; g += nwarps) {
    const int s = g / n, g0 = s * n, g1 = g0 + n;
    const int R0 = P0[g0], E0 = P1[g0], G0 = P2[g0];
    const int base = 2 * L + R0 + E0 + 2 * G0;
    const int Rs = P0[g1] - R0, Es = P1[g1] - E0;
    int rpos = base + (P0[g] - R0);
    int epos = base + Rs + (P1[g] - E0);
    int gpos = base + Rs + Es + 2 * (P2[g] - G0);
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int l = l0 + lane;
      const uint32_t r = l < L ? rec[static_cast<size_t>(g) * L + l] : 0u;
      const uint32_t bn = __ballot_sync(0xFFFFFFFFu, r & kRenorm);
      const uint32_t be = __ballot_sync(0xFFFFFFFFu, r & kEscape);
      const uint32_t bg = __ballot_sync(0xFFFFFFFFu, r & kBig);
      if (r & kRenorm) out[rpos + __popc(bn & lt)] = static_cast<uint16_t>(r & 0xFFFFu);
      if (r & kEscape) {
        const EncSymbol e = enc_symbol(sym, idx, t, plane0 + static_cast<size_t>(s) * sc,
                                       s * sc, (g - g0) * L + l, sc, HW);
        out[epos + __popc(be & lt)] =
            static_cast<uint16_t>((r & kBig) ? kTier1Marker : e.raw);
        if (r & kBig) {
          const int q = gpos + 2 * __popc(bg & lt);
          out[q] = static_cast<uint16_t>(e.raw & 0xFFFFu);
          out[q + 1] = static_cast<uint16_t>(e.raw >> 16);
        }
      }
      rpos += __popc(bn);
      epos += __popc(be);
      gpos += 2 * __popc(bg);
    }
  }
}

// A word of the buffer, 0 outside it.
__device__ __forceinline__ uint32_t read_word(const uint16_t* words, long long n_words,
                                              long long at) {
  return (at >= 0 && at < n_words) ? words[at] : 0u;
}

__global__ void __launch_bounds__(kMaxThreads)
rans_decode_section_kernel(const uint16_t* __restrict__ words, long long n_words,
                           const int* __restrict__ img_base, const int* __restrict__ cursor_in,
                           const uint32_t* __restrict__ state_in,
                           const uint8_t* __restrict__ idx, const uint16_t* __restrict__ lut,
                           Tables t, int sc, int HW, int L, int flags, int esc_cap,
                           int* __restrict__ esc_pos, void* __restrict__ out,
                           int* __restrict__ cursor_out, uint32_t* __restrict__ state_out) {
  __shared__ uint32_t xs[4096];                 // lane states
  __shared__ uint32_t warp_cnt[2][kMaxWarps];   // renorm count | escape count << 16
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nwarps = T >> 5;
  const uint32_t lt = (1u << lane) - 1u;
  const int n_sym = sc * HW;
  const int n = n_sym / L;
  const int rounds = (L + T - 1) / T;           // lanes per thread
  const long long base = img_base[b];
  const size_t plane0 = static_cast<size_t>(b) * sc;
  int16_t* out16 = static_cast<int16_t*>(out);
  int32_t* out32 = static_cast<int32_t*>(out);
  esc_pos += static_cast<size_t>(b) * n_sym;
  long long cur = cursor_in[b];

  if (state_in == nullptr) {                    // first section: the flush
    for (int l = tid; l < L; l += T) {
      const long long at = base + cur + 2 * l;
      xs[l] = read_word(words, n_words, at) | (read_word(words, n_words, at + 1) << 16);
    }
    cur += 2 * L;
  } else {
    for (int l = tid; l < L; l += T) xs[l] = state_in[static_cast<size_t>(b) * L + l];
  }

  // One iteration is one round of one step: T lanes of step it / rounds.
  const int iters = n * rounds;
  int n_esc = 0, buf = 0;
  int c_next = 0;
  size_t a_next = 0;
  int row_next = 0;
  bool active_next = tid < L && iters > 0;
  if (active_next) {
    a_next = plane_addr(plane0, tid, sc, HW, &c_next);
    row_next = idx ? idx[a_next] : c_next;
  }
  for (int it = 0; it < iters; ++it) {
    const int l = (it % rounds) * T + tid;
    const int p = (it / rounds) * L + l;
    const bool active = active_next;
    const int row = clamp_row(row_next, t.rows);
    const size_t a = a_next;
    if (it + 1 < iters) {                        // the next step's CDF row
      const int l1 = ((it + 1) % rounds) * T + tid;
      active_next = l1 < L;
      if (active_next) {
        a_next = plane_addr(plane0, ((it + 1) / rounds) * L + l1, sc, HW, &c_next);
        row_next = idx ? idx[a_next] : c_next;
      }
    }
    bool need = false, esc = false;
    uint32_t x = 0;
    if (active) {
      x = xs[l];
      const uint32_t cum = x & 0xFFFFu;
      const int bin = lut[static_cast<size_t>(row) * kLutSize + cum];
      const uint32_t pr = t.pair[static_cast<size_t>(row) * t.cols + bin];
      x = (pr >> 16) * (x >> 16) + cum - (pr & 0xFFFFu);
      need = x < kRansL;
      esc = bin == t.maxv[row];
      const int value = bin + t.offsets[row];
      if (flags & kOutInt16) out16[a] = static_cast<int16_t>(value);
      else out32[a] = value;
    }
    const uint32_t bn = __ballot_sync(0xFFFFFFFFu, need);
    const uint32_t be = __ballot_sync(0xFFFFFFFFu, esc);
    if (lane == 0) warp_cnt[buf][warp] = __popc(bn) | (__popc(be) << 16);
    __syncthreads();
    uint32_t before = 0, all = 0;
    for (int w = 0; w < nwarps; ++w) {
      const uint32_t c = warp_cnt[buf][w];
      if (w < warp) before += c;
      all += c;
    }
    if (need) {
      const int rank = (before & 0xFFFFu) + __popc(bn & lt);
      x = (x << 16) | read_word(words, n_words, base + cur + rank);
    }
    if (active) xs[l] = x;
    if (esc) esc_pos[n_esc + (before >> 16) + __popc(be & lt)] = p;
    cur += all & 0xFFFFu;
    n_esc += all >> 16;
    buf ^= 1;
  }
  __syncthreads();                               // esc_pos and xs are complete
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
      if (lane == 0) warp_cnt[buf][warp] = __popc(bb);
      __syncthreads();
      int before = 0, all = 0;
      for (int w = 0; w < nwarps; ++w) {
        const int c = warp_cnt[buf][w];
        if (w < warp) before += c;
        all += c;
      }
      if (act) {
        uint32_t raw = w1;
        if (big && (flags & kTier2)) {
          const long long q = t2 + 2ll * (n_big + before + __popc(bb & lt));
          raw = read_word(words, n_words, q) | (read_word(words, n_words, q + 1) << 16);
        }
        int c;
        const size_t a = plane_addr(plane0, esc_pos[e], sc, HW, &c);
        const int row = clamp_row(idx ? idx[a] : c, t.rows);
        const int v = (raw & 1u) ? -static_cast<int>(raw >> 1) - 1
                                 : static_cast<int>(raw >> 1) + t.maxv[row];
        const int value = v + t.offsets[row];
        if (flags & kOutInt16) out16[a] = static_cast<int16_t>(value);
        else out32[a] = value;
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

// R1. sym [B, C, HW] int16 (int32 with sym_wide) and idx [B, C, HW] uint8 (or null: CDF row =
// channel), S sections of C / S channels each, L lanes (a power of two
// dividing C / S * HW). Scratch: rec [B, C * HW] uint32, prefix
// [B, 3, S * n + 1] int32 with n = C / S * HW / L. Out: words [B, cap] with
// cap >= 2L + 4 * C * HW, counts [B], esc_counts [B, S], big_counts [B].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dcvic_rans_encode_pack(const void* sym, int sym_wide, const void* idx,
                                      const void* pair,
                                      const void* offsets, const void* maxv, int rows,
                                      int cols, int B, int C, int HW, int S, int L, void* rec,
                                      void* prefix, void* out, int cap, void* counts,
                                      void* esc_counts, void* big_counts, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || S <= 0 || C % S || L <= 0 || L > 4096 || (L & (L - 1)) ||
      (static_cast<long long>(C / S) * HW) % L ||
      cap < 2 * L + 4ll * C * HW)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{static_cast<const uint32_t*>(pair), static_cast<const int*>(offsets),
                 static_cast<const int*>(maxv), rows, cols};
  rans_encode_pack_kernel<<<B, kMaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      SymbolPlanes{sym, sym_wide}, static_cast<const uint8_t*>(idx), t, C, HW, S, L,
      static_cast<uint32_t*>(rec), static_cast<int*>(prefix), static_cast<uint16_t*>(out), cap,
      static_cast<int*>(counts), static_cast<int*>(esc_counts), static_cast<int*>(big_counts));
  return static_cast<int>(cudaGetLastError());
}

// R2. One section [B, sc, HW] of every image's stream. words: all streams
// back to back; img_base, cursor_in [B]; state_in [B, L] or null for a
// stream's first section; idx [B, sc, HW] uint8 or null (CDF row = channel);
// lut [rows, 65536] uint16. Scratch esc_pos [B, sc * HW] int32. Out: symbols
// [B, sc, HW] int16 (flag 8) or int32, cursor_out [B], state_out [B, L].
// flags: 1 escape-free guarantee, 2 resolve tier 2, 4 hold to esc_cap, 8
// int16 output. Returns the cudaError_t of the launch (0 on success).
extern "C" int dcvic_rans_decode_section(const void* words, long long n_words,
                                         const void* img_base, const void* cursor_in,
                                         const void* state_in, const void* idx,
                                         const void* lut, const void* pair,
                                         const void* offsets, const void* maxv, int rows,
                                         int cols, int B, int sc, int HW, int L, int flags,
                                         int esc_cap, void* esc_pos, void* out,
                                         void* cursor_out, void* state_out, void* stream) {
  if (B <= 0 || sc <= 0 || HW <= 0 || L <= 0 || L > 4096 || (L & (L - 1)) ||
      (static_cast<long long>(sc) * HW) % L)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{static_cast<const uint32_t*>(pair), static_cast<const int*>(offsets),
                 static_cast<const int*>(maxv), rows, cols};
  const int threads = L < 32 ? 32 : (L > kMaxThreads ? kMaxThreads : L);
  rans_decode_section_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(words), n_words, static_cast<const int*>(img_base),
      static_cast<const int*>(cursor_in), static_cast<const uint32_t*>(state_in),
      static_cast<const uint8_t*>(idx), static_cast<const uint16_t*>(lut), t, sc, HW, L, flags,
      esc_cap, static_cast<int*>(esc_pos), out, static_cast<int*>(cursor_out),
      static_cast<uint32_t*>(state_out));
  return static_cast<int>(cudaGetLastError());
}
