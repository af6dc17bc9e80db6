// Encode-pass walks of the ULC bitstream for Hopper (sm_90a).
//
// Four kernels, one per Pallas call of ulcx/bitstream/pallas_encode3.py:
//   p1_kernel            <- _p1 (forward zone scan, :124; pallas_call at :546)
//   p2_kernel            <- _p2 (reverse backfill, :186; :559)
//   p3_kernel<false>     <- _p3, size-only (:254; :587)
//   p3_kernel<true>      <- _p3, materialize (:254; :601)
// Each computes what its Pallas kernel computes, not its block
// structure: the TPU grid's chunk loop, its VMEM scratch carry and the
// unrolled chunk bodies have no counterpart here.
//
// Layouts (the wrappers in bitstream/encode_kernels.py check them):
//   per-position planes  [P, B]    stream fastest (key, coef, aux, thr)
//   line planes          [P/2, B]  read at p >> 1 (ampn, hfamp, hfmeta)
//   per-candidate        [B, 8]    walker b * 8 + cand (t, c, bits)
//   state planes         [P, B, 8] (s12, state): 4 streams' rows are
//                                   128 contiguous bytes per position
//   words                [B, 8, n_words]
//
// Bound: bytes (each input read once, each output written once) at the
// flagship shape B = 512, P = 4096, over 3.35 TB/s: p1 92.3 MB -> 27.6
// us; p2 159.4 MB -> 47.6 us; p3 size 83.9 MB -> 25.0 us; p3
// materialize 130.0 MB -> 38.8 us. Each walk is a serial recurrence
// over P with carried state, so none reaches that bound: what sets its
// time is the latency of one step of the carried chain. The first
// design (one thread per (stream, candidate) for p1, one warp per block
// for p2/p3, loads straight from device memory in the chain) paid one
// memory latency a step: 1.20, 3.29, 2.19 and 5.67 ms. This design
// takes the memory out of the chain (the ring machinery is in
// walk_ring.cuh):
//   - a CTA holds a tile of 4 streams x 8 candidates: warp 0 is the 32
//     walkers, warps 1.. are helpers (the launch geometry, chunk length
//     and shared-memory bytes come from encode_kernels.walk_geometry);
//   - the helpers fill a 2-stage ring of shared-memory stages, each a
//     chunk of L positions (p1 and p3 from low p to high, p2 from high
//     to low, as each walks; p3 with one overlap row of coef for the
//     p+1 look-ahead, and half-height tiles of the line planes), with
//     cp.async (4-byte copies for the [P, B] planes, so any B is served;
//     16-byte copies for the [P, B, 8] planes, whose 32-byte rows are
//     always aligned);
//   - the helpers run a carry-free pre-pass over each chunk, data-
//     parallel over (position, walker), that packs into one or two
//     shared-memory words everything that does not depend on the
//     carried state (p1: |coef| with denormals flushed and the kept bit
//     in its sign bit, plus the segment-start bit per stream; p2: kept,
//     qi, split, thr & 63, segdelta; p3: the event class, run length
//     and count, segment and tail bits, and, when materializing, the
//     coefficient and noise nybbles, whose three cq_unsigned square
//     roots thereby leave the chain);
//   - the walkers step through the previous chunk reading one or two
//     words from shared memory and update only the carry; p1 and p2
//     write one word per (position, walker) to a shared-memory stage
//     that the helpers store as 16-byte rows (p1's helpers first turn
//     the running max into the zone quantizer, so its logf leaves the
//     chain too), p3 materialize stores each completed word at its
//     index;
//   - one __syncthreads a chunk separates load (chunk k+1), pre-pass
//     (k), walk (k-1) and post-pass and store (k-2).
//
// Numerics: built without --use_fast_math, so logf/sqrtf are the
// accurate ones and denormals are not flushed behind the code's back
// (the zone scan flushes denormal magnitudes itself, as the TPU
// reference does). Float products and sums use the _rn intrinsics so
// that nvcc cannot contract them into FMAs: the plain PyTorch versions
// round each operation separately. Every float -> int conversion is
// clipped first.

#include "walk_ring.cuh"

namespace {

// Positions: P = n_chan * block_size <= 255 * 32768 < 2^23. The state
// word keeps the next coded position in 24 bits, kNcpMax meaning none.
constexpr int kSent = 1 << 24;          // "no position" sentinel (> any p)
constexpr int kNcpMax = (1 << 24) - 1;  // kSent clamped into the state word
// BuildQuantizer constants (reference ulcEncoder_Encode.c:50-87):
// qi = clip(floor(A - log2(max)), 5, 31), A = 5 + log2(1.5)
constexpr float kBqA = 0x1.657006p2f;
constexpr float kInvLn2 = 0x1.715476p0f;
constexpr float kFltMin = 0x1p-126f;  // smallest normal f32
constexpr float kIntMaxF = 2147483520.0f;  // largest f32 below 2^31

__device__ __forceinline__ bool kept_at(int key, int t, int c, int p) {
  return key > t || (key == t && p <= c);
}

// Companded quantize |v| (reference ulcHelper.h:50-65). The result
// saturates at INT32_MAX, as XLA's float-to-int conversion does, so an
// infinite HF amplitude still counts as "nonzero".
__device__ __forceinline__ int cq_unsigned(float v) {
  float q = floorf(__fadd_rn(0.5f, __fsqrt_rn(fmaxf(__fsub_rn(v, 0.25f), 0.0f))));
  return v >= 0.5f ? static_cast<int>(fminf(q, kIntMaxF)) : 0;
}

// 2^q as f32 for q clipped to [0, 31], by exponent-field construction.
__device__ __forceinline__ float exp2i(int q) {
  q = min(max(q, 0), 31);
  return __int_as_float((q + 127) << 23);
}

// --- stage layouts ----------------------------------------------------------

// One stage's arrays, as byte offsets from the stage's base; the ring
// holds kStages stages back to back, then `extra` bytes. Mirrored by
// encode_kernels.walk_smem_bytes.
struct P1Layout {
  int key, coef, aux, seg, pp, out, stage, tc, total;
};
__host__ __device__ inline P1Layout p1_layout(int L) {
  P1Layout l{};
  l.key = 0;
  l.coef = l.key + arr(L * kTile);
  l.aux = l.coef + arr(L * kTile);
  l.seg = l.aux + arr(L * kTile);
  l.pp = l.seg + arr(L * kTile);
  l.out = l.pp + arr(L * kWalkers);
  l.stage = l.out + arr(L * kWalkers);
  l.tc = kStages * l.stage;
  l.total = l.tc + arr(2 * kWalkers);
  return l;
}

struct P2Layout {
  int key, thr, aux, s12, pp, out, stage, tc, total;
};
__host__ __device__ inline P2Layout p2_layout(int L) {
  P2Layout l{};
  l.key = 0;
  l.thr = l.key + arr(L * kTile);
  l.aux = l.thr + arr(L * kTile);
  l.s12 = l.aux + arr(L * kTile);
  l.pp = l.s12 + arr(L * kWalkers);
  l.out = l.pp + arr(L * kWalkers);
  l.stage = l.out + arr(L * kWalkers);
  l.tc = kStages * l.stage;
  l.total = l.tc + arr(2 * kWalkers);
  return l;
}

struct P3Layout {
  int aux, thr, st, coef, ampn, hfamp, hfmeta, pp0, pp1, hf, stage, total;
};
__host__ __device__ inline P3Layout p3_layout(int L, bool mat) {
  P3Layout l{};
  const int half = L / 2;
  l.aux = 0;
  l.thr = l.aux + arr(L * kTile);
  l.st = l.thr + (mat ? 0 : arr(L * kTile));
  l.coef = l.st + arr(L * kWalkers);
  l.ampn = l.coef + (mat ? arr((L + 1) * kTile) : 0);
  l.hfamp = l.ampn + (mat ? arr(half * kTile) : 0);
  l.hfmeta = l.hfamp + (mat ? arr(half * kTile) : 0);
  l.pp0 = l.hfmeta + (mat ? arr(half * kTile) : 0);
  l.pp1 = l.pp0 + arr(L * kWalkers);
  l.hf = l.pp1 + (mat ? arr(L * kWalkers) : 0);
  l.stage = l.hf + (mat ? arr(half * kTile) : 0);
  l.total = kStages * l.stage;
  return l;
}

// --- p1 ---------------------------------------------------------------------

// The zone quantizer of a post-pass word: qi = clip(floor(A - log2(m)),
// 5, 31) | split << 5, from m = max(qmax, 1e-38) in bits 0-30 and the
// split bit in bit 31. Clipped in float before the int conversion: log
// of a flushed or zero maximum is -inf and the quotient +inf.
__device__ __forceinline__ int zone_qi(uint32_t w) {
  float x = floorf(__fsub_rn(kBqA, __fmul_rn(kInvLn2, logf(__uint_as_float(w & 0x7FFFFFFFu)))));
  x = fminf(fmaxf(x, 5.0f), 31.0f);
  return static_cast<int>(x) | static_cast<int>((w >> 31) << 5);
}

// Forward zone scan: running min/max of |coef| over kept positions,
// reset at segment starts, zone split when max > 4 * min. Emits the
// zone quantizer index qi | split << 5.
//
// Pre-pass word: bits 0-30 |coef| with denormal magnitudes flushed to 0
// (as on the TPU the zone logic was written for: IEEE compares would
// split zones at max(0, denormal) > 4 * 0) | kept << 31; per (position,
// stream) the segment-start bit. Walker word: bits 0-30 max(qmax, 1e-38)
// | split << 31, which the post-pass turns into qi.
__global__ void __launch_bounds__(kMaxThreads)
    p1_kernel(const int* __restrict__ t, const int* __restrict__ c, const int* __restrict__ key,
              const float* __restrict__ coef, const int* __restrict__ aux, int* __restrict__ s12,
              int B, int P, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const P1Layout ly = p1_layout(L);
  const int b0 = blockIdx.x * kTile, ns = min(kTile, B - b0);
  const int nchunks = (P + L - 1) / L;
  const int tid = threadIdx.x, nh = blockDim.x - kWalkers, h = tid - kWalkers;
  int* tc_s = reinterpret_cast<int*>(smem + ly.tc);
  auto arr_at = [&](int k, int off) { return reinterpret_cast<int*>(smem + (k & 1) * ly.stage + off); };

  auto load = [&](int k) {
    const Span s = chunk_span(k, L, P, false);
    const int n = s.hi - s.lo;
    copy_rows(arr_at(k, ly.key), kTile, key, s.lo, n, B, b0, ns, h, nh);
    copy_rows(arr_at(k, ly.coef), kTile, reinterpret_cast<const int*>(coef), s.lo, n, B, b0, ns,
              h, nh);
    copy_rows(arr_at(k, ly.aux), kTile, aux, s.lo, n, B, b0, ns, h, nh);
  };

  if (tid >= kWalkers) {
    for (int i = h; i < ns * kCand; i += nh) {
      tc_s[i] = t[b0 * kCand + i];
      tc_s[kWalkers + i] = c[b0 * kCand + i];
    }
    load(0);
    __pipeline_commit();
  }
  __syncthreads();

  const int lane = tid & 31, j = lane / kCand;
  float qmin = 1000.0f, qmax = -1000.0f;
  for (int k = 0; k <= nchunks + 1; ++k) {
    if (tid < kWalkers) {
      if (k >= 1 && k <= nchunks) {  // walk chunk k - 1
        const Span s = chunk_span(k - 1, L, P, false);
        const int n = s.hi - s.lo;
        const uint32_t* pp = reinterpret_cast<const uint32_t*>(arr_at(k - 1, ly.pp));
        const int* seg = arr_at(k - 1, ly.seg);
        uint32_t* out = reinterpret_cast<uint32_t*>(arr_at(k - 1, ly.out));
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const uint32_t w = pp[i * kWalkers + lane];
          if (seg[i * kTile + j]) {
            qmin = 1000.0f;
            qmax = -1000.0f;
          }
          const float a = __uint_as_float(w & 0x7FFFFFFFu);
          const bool kept = w >> 31;
          const float nmin = fminf(qmin, a), nmax = fmaxf(qmax, a);
          const bool split = kept && (nmax > __fmul_rn(nmin, 4.0f));
          if (kept) {
            qmin = split ? a : nmin;
            qmax = split ? a : nmax;
          }
          out[i * kWalkers + lane] =
              __float_as_uint(fmaxf(qmax, 1e-38f)) | (static_cast<uint32_t>(split) << 31);
        }
      }
    } else {
      if (k + 1 < nchunks) load(k + 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this thread's copies of chunk k landed
      helpers_sync(nh);          // and every helper's
      if (k < nchunks) {         // pre-pass of chunk k
        const Span s = chunk_span(k, L, P, false);
        const int n = s.hi - s.lo;
        const int* key_s = arr_at(k, ly.key);
        const int* coef_s = arr_at(k, ly.coef);
        const int* aux_s = arr_at(k, ly.aux);
        int* seg = arr_at(k, ly.seg);
        uint32_t* pp = reinterpret_cast<uint32_t*>(arr_at(k, ly.pp));
        for (int e = h; e < n * kWalkers; e += nh) {
          const int i = e / kWalkers, wl = e % kWalkers, jj = wl / kCand;
          if (jj >= ns) continue;
          const int x = i * kTile + jj;
          float a = fabsf(__int_as_float(coef_s[x]));
          if (a < kFltMin) a = 0.0f;
          const bool kept = kept_at(key_s[x], tc_s[wl], tc_s[kWalkers + wl], s.lo + i);
          pp[e] = __float_as_uint(a) | (static_cast<uint32_t>(kept) << 31);
        }
        for (int e = h; e < n * kTile; e += nh) seg[e] = (aux_s[e] >> 16) & 1;
      }
      if (k >= 2) {  // post-pass: chunk k - 2's zone quantizers, 16 bytes a thread
        const Span s = chunk_span(k - 2, L, P, false);
        const uint32_t* out = reinterpret_cast<const uint32_t*>(arr_at(k - 2, ly.out));
        const int per_row = ns * 2;
        for (int e = h; e < (s.hi - s.lo) * per_row; e += nh) {
          const int i = e / per_row, q = e - i * per_row;
          const uint4 w = *reinterpret_cast<const uint4*>(out + i * kWalkers + q * 4);
          *reinterpret_cast<int4*>(s12 + (static_cast<size_t>(s.lo + i) * B + b0) * kCand +
                                   q * 4) =
              make_int4(zone_qi(w.x), zone_qi(w.y), zone_qi(w.z), zone_qi(w.w));
        }
      }
    }
    __syncthreads();
  }
}

// --- p2 ---------------------------------------------------------------------

// Reverse backfill: zone ends and each zone's quantizer; a kept
// position is coded when q >= qmin(|coef|, 2.5) from the packed
// threshold plane. Emits next_coded_pos (24 bits, kNcpMax for none) |
// q << 24 | coded << 29.
//
// Pre-pass word: kept | (qi | split << 5) << 1 | (thr & 63) << 7 |
// segdelta << 13 (a segment lies in one channel: segdelta <= 32768, so
// the word takes 29 bits); the walker adds its p.
__global__ void __launch_bounds__(kMaxThreads)
    p2_kernel(const int* __restrict__ t, const int* __restrict__ c, const int* __restrict__ key,
              const int* __restrict__ thr, const int* __restrict__ aux,
              const int* __restrict__ s12, int* __restrict__ state, int B, int P, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const P2Layout ly = p2_layout(L);
  const int b0 = blockIdx.x * kTile, ns = min(kTile, B - b0);
  const int nchunks = (P + L - 1) / L;
  const int tid = threadIdx.x, nh = blockDim.x - kWalkers, h = tid - kWalkers;
  int* tc_s = reinterpret_cast<int*>(smem + ly.tc);
  auto arr_at = [&](int k, int off) { return reinterpret_cast<int*>(smem + (k & 1) * ly.stage + off); };

  auto load = [&](int k) {
    const Span s = chunk_span(k, L, P, true);
    const int n = s.hi - s.lo;
    copy_rows(arr_at(k, ly.key), kTile, key, s.lo, n, B, b0, ns, h, nh);
    copy_rows(arr_at(k, ly.thr), kTile, thr, s.lo, n, B, b0, ns, h, nh);
    copy_rows(arr_at(k, ly.aux), kTile, aux, s.lo, n, B, b0, ns, h, nh);
    copy_cand_rows(arr_at(k, ly.s12), s12, s.lo, n, B, b0, ns, h, nh);
  };

  if (tid >= kWalkers) {
    for (int i = h; i < ns * kCand; i += nh) {
      tc_s[i] = t[b0 * kCand + i];
      tc_s[kWalkers + i] = c[b0 * kCand + i];
    }
    load(0);
    __pipeline_commit();
  }
  __syncthreads();

  const int lane = tid & 31;
  int nk = kSent, nk_split = 0, cur_qi = 31, q_next = 31, ncp = kSent;
  for (int k = 0; k <= nchunks + 1; ++k) {
    if (tid < kWalkers) {
      if (k >= 1 && k <= nchunks) {  // walk chunk k - 1, high p to low
        const Span s = chunk_span(k - 1, L, P, true);
        const uint32_t* pp = reinterpret_cast<const uint32_t*>(arr_at(k - 1, ly.pp));
        int* out = arr_at(k - 1, ly.out);
        int i = s.hi - s.lo - 1;
        uint32_t wn = pp[i * kWalkers + lane];
        for (; i >= 0; --i) {
          const uint32_t w = wn;
          if (i > 0) wn = pp[(i - 1) * kWalkers + lane];
          const int p = s.lo + i;
          const bool kept = w & 1u;
          if (kept && (nk >= kSent || nk_split == 1 || nk >= p + static_cast<int>(w >> 13)))
            cur_qi = (w >> 1) & 0x1F;
          const bool coded = kept && cur_qi >= static_cast<int>((w >> 7) & 63);
          if (coded) {
            q_next = cur_qi;
            ncp = p;
          }
          out[i * kWalkers + lane] =
              min(max(ncp, 0), kNcpMax) | (q_next << 24) | (static_cast<int>(coded) << 29);
          if (kept) {
            nk = p;
            nk_split = (w >> 6) & 1;
          }
        }
      }
    } else {
      if (k + 1 < nchunks) load(k + 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this thread's copies of chunk k landed
      helpers_sync(nh);          // and every helper's
      if (k < nchunks) {         // pre-pass of chunk k
        const Span s = chunk_span(k, L, P, true);
        const int* key_s = arr_at(k, ly.key);
        const int* thr_s = arr_at(k, ly.thr);
        const int* aux_s = arr_at(k, ly.aux);
        const int* s12_s = arr_at(k, ly.s12);
        uint32_t* pp = reinterpret_cast<uint32_t*>(arr_at(k, ly.pp));
        for (int e = h; e < (s.hi - s.lo) * kWalkers; e += nh) {
          const int i = e / kWalkers, wl = e % kWalkers, j = wl / kCand;
          if (j >= ns) continue;
          const int x = i * kTile + j;
          const bool kept = kept_at(key_s[x], tc_s[wl], tc_s[kWalkers + wl], s.lo + i);
          pp[e] = static_cast<uint32_t>(kept) | (static_cast<uint32_t>(s12_s[e] & 0x3F) << 1) |
                  (static_cast<uint32_t>(thr_s[x] & 63) << 7) |
                  (static_cast<uint32_t>(aux_s[x] & 0xFFFF) << 13);
        }
      }
      if (k >= 2) {  // store chunk k - 2's state rows, 16 bytes a thread
        const Span s = chunk_span(k - 2, L, P, true);
        const int* out = arr_at(k - 2, ly.out);
        const int per_row = ns * 2;
        for (int e = h; e < (s.hi - s.lo) * per_row; e += nh) {
          const int i = e / per_row, q = e - i * per_row;
          *reinterpret_cast<int4*>(state + (static_cast<size_t>(s.lo + i) * B + b0) * kCand +
                                   q * 4) =
              *reinterpret_cast<const int4*>(out + i * kWalkers + q * 4);
        }
      }
    }
    __syncthreads();
  }
}

// --- p3 ---------------------------------------------------------------------

// Forward emission walk. Each position yields one of five events (coded
// coefficient, rescue pair, noise run, short zero run, long zero run),
// plus quantizer-change tokens and one segment-tail token (HF extension,
// stop, or zero tail). Size mode counts nybbles from the packed
// threshold plane; materialize mode reads the value planes, packs the
// nybbles through a u32 shift register and stores each completed word
// at its index. The final partial register goes to index wcount.
//
// Pre-pass word 0: qq 0-4 | is_code 5 | gp 6 | ext_q 7 | body count
// 8-10 | advance 11-20 | segment start 21 | tail possible 22 | HF
// candidate (n_tail >= 16 and hfok) 23 | n_tail > 4 24 | 0 < n_tail <= 4
// 25 | size mode: qmin(hfamp) 26-31. Word 1 (materialize): the four
// event nybbles 0-15 | dec_t 16-23 | zero-tail nybble 24-27. Per (line,
// stream) the HF amplitude, whose quantization needs the carried q.
template <bool kMat>
__global__ void __launch_bounds__(kMaxThreads)
    p3_kernel(const int* __restrict__ thr, const int* __restrict__ aux,
              const int* __restrict__ state, const float* __restrict__ coef,
              const float* __restrict__ ampn, const float* __restrict__ hfamp,
              const int* __restrict__ hfmeta, const int* __restrict__ hdr,
              int* __restrict__ bits_out, int* __restrict__ words, int* __restrict__ freg_out,
              int* __restrict__ fwc_out, int B, int P, int n_words, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const P3Layout ly = p3_layout(L, kMat);
  const int b0 = blockIdx.x * kTile, ns = min(kTile, B - b0);
  const int nchunks = (P + L - 1) / L;
  const int tid = threadIdx.x, nh = blockDim.x - kWalkers, h = tid - kWalkers;
  auto arr_at = [&](int k, int off) { return reinterpret_cast<int*>(smem + (k & 1) * ly.stage + off); };

  auto load = [&](int k) {
    const Span s = chunk_span(k, L, P, false);
    const int n = s.hi - s.lo;
    copy_rows(arr_at(k, ly.aux), kTile, aux, s.lo, n, B, b0, ns, h, nh);
    copy_cand_rows(arr_at(k, ly.st), state, s.lo, n, B, b0, ns, h, nh);
    if (kMat) {
      // rows lo..hi: the last is the p + 1 look-ahead, clipped at P - 1
      int* coef_s = arr_at(k, ly.coef);
      for (int e = h; e < (n + 1) * ns; e += nh) {
        const int i = e / ns, j = e - i * ns;
        __pipeline_memcpy_async(
            coef_s + i * kTile + j,
            coef + static_cast<size_t>(min(s.lo + i, P - 1)) * B + b0 + j, 4);
      }
      const int line0 = s.lo >> 1, nl = (n + 1) >> 1;
      copy_rows(arr_at(k, ly.ampn), kTile, reinterpret_cast<const int*>(ampn), line0, nl, B, b0,
                ns, h, nh);
      copy_rows(arr_at(k, ly.hfamp), kTile, reinterpret_cast<const int*>(hfamp), line0, nl, B,
                b0, ns, h, nh);
      copy_rows(arr_at(k, ly.hfmeta), kTile, hfmeta, line0, nl, B, b0, ns, h, nh);
    } else {
      copy_rows(arr_at(k, ly.thr), kTile, thr, s.lo, n, B, b0, ns, h, nh);
    }
  };

  auto prepass = [&](int k) {
    const Span s = chunk_span(k, L, P, false);
    const int n = s.hi - s.lo;
    const int* aux_s = arr_at(k, ly.aux);
    const int* st_s = arr_at(k, ly.st);
    uint32_t* pp0 = reinterpret_cast<uint32_t*>(arr_at(k, ly.pp0));
    uint32_t* pp1 = reinterpret_cast<uint32_t*>(arr_at(k, ly.pp1));
    for (int e = h; e < n * kWalkers; e += nh) {
      const int i = e / kWalkers, j = (e % kWalkers) / kCand;
      if (j >= ns) continue;
      const int p = s.lo + i, x = i * kTile + j, xl = (i >> 1) * kTile + j;
      const int ax = aux_s[x];
      const int segdelta = ax & 0xFFFF;
      const int srow = st_s[e];
      const int ncp = srow & kNcpMax;
      const int qq = (srow >> 24) & 0x1F;
      const bool is_code = (srow >> 29) & 1;
      const bool is_tail = (ncp - p) >= segdelta;
      const bool gp = !is_code && !is_tail;
      const int sq = qq - 5;
      const int ext_q = sq >= 14;
      const int z_r = min(max(ncp - p, 0), kSent);

      bool resc_ok, noise_ok, hfok;
      int th = 0, qn1 = 0, qn2 = 0, nq_est = 0;
      if (kMat) {
        const float* coef_s = reinterpret_cast<const float*>(arr_at(k, ly.coef));
        const float scale = exp2i(qq);
        const float c0 = coef_s[x];
        const float c1 = coef_s[x + kTile];
        qn1 = min(cq_unsigned(__fmul_rn(fabsf(c0), scale)), 7);
        if (c0 < 0.0f) qn1 = -qn1;
        qn2 = min(cq_unsigned(__fmul_rn(fabsf(c1), scale)), 7);
        if (c1 < 0.0f) qn2 = -qn2;
        const float amp = reinterpret_cast<const float*>(arr_at(k, ly.ampn))[xl];
        nq_est = amp > 0.0f ? min(cq_unsigned(__fmul_rn(amp, scale)), 8) : 0;
        resc_ok = abs(qn1) > 1 && (z_r < 2 || abs(qn2) > 1);
        noise_ok = nq_est > 0;
        hfok = (arr_at(k, ly.hfmeta)[xl] >> 8) == 1;
      } else {
        th = arr_at(k, ly.thr)[x];
        resc_ok = qq >= (th & 63) && (z_r < 2 || qq >= ((th >> 6) & 63));
        noise_ok = qq >= ((th >> 12) & 63);
        hfok = (th >> 24) & 1;
      }
      const bool do_resc = gp && z_r <= 2 && resc_ok;
      const bool do_noise = gp && !do_resc && z_r >= 16 && noise_ok;
      const bool do_zs = gp && !do_resc && !do_noise && z_r < 33;
      const int run_n = do_resc    ? z_r
                        : do_noise ? min(z_r, 527)
                        : do_zs    ? min(z_r, 16)
                                   : min(z_r, 288);
      const int run_cnt = do_resc ? z_r : do_noise ? 4 : do_zs ? 2 : 3;
      uint32_t w0 = static_cast<uint32_t>(qq) | (static_cast<uint32_t>(is_code) << 5) |
                    (static_cast<uint32_t>(gp) << 6) | (static_cast<uint32_t>(ext_q) << 7) |
                    (static_cast<uint32_t>(is_code ? 1 : run_cnt) << 8) |
                    (static_cast<uint32_t>(is_code ? 1 : run_n) << 11) |
                    (static_cast<uint32_t>((ax >> 16) & 1) << 21) |
                    (static_cast<uint32_t>(!is_code && is_tail) << 22) |
                    (static_cast<uint32_t>(segdelta >= 16 && hfok) << 23) |
                    (static_cast<uint32_t>(segdelta > 4) << 24) |
                    (static_cast<uint32_t>(segdelta > 0 && segdelta <= 4) << 25);
      if (kMat) {
        // t0 reads qn1 for a coded event too: when the position is coded
        // and not active, its count is 0 and the nybbles are masked away
        const int v_noise = run_n - 16, v_long = run_n - 33;
        const int t0 = (is_code || do_resc) ? (qn1 & 0xF) : do_noise ? 0x8 : do_zs ? 0x0 : 0x1;
        const int t1 = do_resc     ? (qn2 & 0xF)
                       : do_noise ? ((v_noise >> 5) & 0xF)
                       : do_zs    ? (run_n - 1)
                                  : ((v_long >> 4) & 0xF);
        const int t2 = do_noise ? ((v_noise >> 1) & 0xF) : (v_long & 0xF);
        const int t3 = ((v_noise & 1) | ((nq_est - 1) << 1)) & 0xF;
        const int dec_t = arr_at(k, ly.hfmeta)[xl] & 0xFF;
        pp1[e] = static_cast<uint32_t>((t0 & 0xF) | ((t1 & 0xF) << 4) | ((t2 & 0xF) << 8) |
                                       ((t3 & 0xF) << 12)) |
                 (static_cast<uint32_t>(dec_t) << 16) |
                 (static_cast<uint32_t>(min(max(segdelta - 1, 0), 0xF)) << 24);
      } else {
        w0 |= static_cast<uint32_t>((th >> 18) & 63) << 26;
      }
      pp0[e] = w0;
    }
    if (kMat) {  // the HF amplitudes, per (line, stream)
      const int* src = arr_at(k, ly.hfamp);
      int* dst = arr_at(k, ly.hf);
      for (int e = h; e < ((n + 1) >> 1) * kTile; e += nh) dst[e] = src[e];
    }
  };

  if (tid >= kWalkers) {
    load(0);
    __pipeline_commit();
  }

  const int lane = tid & 31, j = lane / kCand;
  const bool active = tid < kWalkers && j < ns;
  int covered = 0, prev_q = -1, bits = 0, tail_done = 0;
  uint32_t reg = 0;
  int fill = 0, wcount = 0;
  int* my_words = nullptr;
  if (kMat && active) {
    const int hd = hdr[b0 + j];
    fill = hd >> 8;
    reg = static_cast<uint32_t>(fill == 2 ? (hd & 0xFF) : (hd & 0xF));
    my_words = words + static_cast<size_t>(b0 * kCand + lane) * n_words;
  }

  for (int k = 0; k <= nchunks; ++k) {
    if (tid < kWalkers) {
      if (k >= 1) {  // walk chunk k - 1
        const Span s = chunk_span(k - 1, L, P, false);
        const int n = s.hi - s.lo;
        const uint32_t* pp0 = reinterpret_cast<const uint32_t*>(arr_at(k - 1, ly.pp0));
        const uint32_t* pp1 = reinterpret_cast<const uint32_t*>(arr_at(k - 1, ly.pp1));
        const float* hf_s = reinterpret_cast<const float*>(arr_at(k - 1, ly.hf));
        uint32_t wn = pp0[lane];
        for (int i = 0; i < n; ++i) {
          const uint32_t w = wn;
          if (i + 1 < n) wn = pp0[(i + 1) * kWalkers + lane];
          const int p = s.lo + i;
          if ((w >> 21) & 1) {
            prev_q = -1;
            tail_done = 0;
          }
          const int qq = w & 0x1F;
          const bool is_code = (w >> 5) & 1;
          const int ext_q = (w >> 7) & 1;
          const bool act = p >= covered && (is_code || ((w >> 6) & 1));
          const int lead = prev_q >= 0;
          const bool need_q = act && qq != prev_q;
          const int q_cnt = need_q ? 1 + ext_q + lead : 0;
          const int cnt = act ? q_cnt + static_cast<int>((w >> 8) & 7) : 0;
          const int new_covered = act ? p + static_cast<int>((w >> 11) & 0x3FF) : covered;
          const int new_prev_q = need_q ? qq : prev_q;

          // tail token: fires at the first in-segment position with
          // nothing coded ahead
          const bool tail_ev = ((w >> 22) & 1) && tail_done == 0;
          const bool pq_valid = prev_q >= 0;
          const bool hf_cand = tail_ev && pq_valid && ((w >> 23) & 1);
          bool do_hf;
          int nq_hf = 0;
          if (kMat) {
            if (hf_cand) {
              const float v =
                  __fmul_rn(__fmul_rn(hf_s[(i >> 1) * kTile + j], exp2i(prev_q)), 4.0f);
              nq_hf = min(cq_unsigned(v), 16);
            }
            do_hf = hf_cand && nq_hf > 0;
          } else {
            do_hf = hf_cand && prev_q >= static_cast<int>(w >> 26);
          }
          const bool do_stop = tail_ev && ((w >> 24) & 1) && !do_hf;
          const bool do_zt = tail_ev && ((w >> 25) & 1);
          const int cnt_tail = do_hf ? 5 : do_stop ? (pq_valid ? 3 : 2) : do_zt ? 2 : 0;
          if (tail_ev) tail_done = 1;
          bits += cnt + cnt_tail;

          if (kMat) {
            const uint32_t w1 = pp1[i * kWalkers + lane];
            uint32_t pos_packed;
            if (tail_ev) {
              const uint32_t dec_t = (w1 >> 16) & 0xFF;
              if (do_hf) {
                pos_packed = 0xFFu | (static_cast<uint32_t>((nq_hf - 1) & 0xF) << 8) |
                             (((dec_t >> 4) & 0xF) << 12) | ((dec_t & 0xF) << 16);
              } else if (do_stop) {
                pos_packed = pq_valid ? (0xFu | (0xEu << 4) | (0xFu << 8)) : (0xEu | (0xFu << 4));
              } else {
                pos_packed = do_zt ? ((w1 >> 24) & 0xF) << 4 : 0u;
              }
            } else {
              const int sq = qq - 5;
              const int qv0 = lead ? 0xF : (ext_q ? 0xE : sq);
              const int qv1 = lead ? (ext_q ? 0xE : sq) : sq - 14;
              const int qv2 = sq - 14;
              const uint32_t qpart = static_cast<uint32_t>((qv0 & 0xF) | ((qv1 & 0xF) << 4) |
                                                           ((qv2 & 0xF) << 8));
              const uint32_t tpart = w1 & 0xFFFFu;
              const uint32_t qm = (1u << (4 * q_cnt)) - 1u;
              const uint32_t hm = (1u << (4 * cnt)) - 1u;  // cnt <= 7
              pos_packed = ((qpart & qm) | (tpart << (4 * q_cnt))) & hm;
            }
            // one u32 holds 8 nybbles; a position adds at most 7, so at
            // most one word completes per position
            const uint32_t full = reg | (pos_packed << (4 * fill));
            const int newfill = fill + cnt + cnt_tail;
            if (newfill >= 8) {
              if (active && wcount < n_words) my_words[wcount] = static_cast<int>(full);
              ++wcount;
              reg = fill == 0 ? 0u : pos_packed >> (32 - 4 * fill);
            } else {
              reg = full;
            }
            fill = newfill & 7;
          }
          covered = new_covered;
          prev_q = new_prev_q;
        }
      }
    } else {
      if (k + 1 < nchunks) load(k + 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this thread's copies of chunk k landed
      helpers_sync(nh);          // and every helper's
      if (k < nchunks) prepass(k);
    }
    __syncthreads();
  }

  if (active) {
    const int w = b0 * kCand + lane;
    bits_out[w] = bits;
    if (kMat) {
      if (wcount < n_words) my_words[wcount] = static_cast<int>(reg);
      freg_out[w] = static_cast<int>(reg);
      fwc_out[w] = wcount;
    }
  }
}

inline int walk_grid(int B) { return (B + kTile - 1) / kTile; }

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, allocates nothing, and returns a cudaError_t as an int: the
// geometry check's, the shared-memory attribute's, or cudaGetLastError()
// after the launch.
extern "C" {

int ulcx_p1(const void* t, const void* c, const void* key, const void* coef, const void* aux,
            void* s12, int B, int P, int L, int threads, int smem, void* stream) {
  static int allowed[kMaxDevices];
  const int rc = prepare_walk(p1_kernel, allowed, L, threads, smem, p1_layout(L).total);
  if (rc) return rc;
  p1_kernel<<<walk_grid(B), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(t), static_cast<const int*>(c), static_cast<const int*>(key),
      static_cast<const float*>(coef), static_cast<const int*>(aux), static_cast<int*>(s12), B,
      P, L);
  return static_cast<int>(cudaGetLastError());
}

int ulcx_p2(const void* t, const void* c, const void* key, const void* thr, const void* aux,
            const void* s12, void* state, int B, int P, int L, int threads, int smem,
            void* stream) {
  static int allowed[kMaxDevices];
  const int rc = prepare_walk(p2_kernel, allowed, L, threads, smem, p2_layout(L).total);
  if (rc) return rc;
  p2_kernel<<<walk_grid(B), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(t), static_cast<const int*>(c), static_cast<const int*>(key),
      static_cast<const int*>(thr), static_cast<const int*>(aux), static_cast<const int*>(s12),
      static_cast<int*>(state), B, P, L);
  return static_cast<int>(cudaGetLastError());
}

int ulcx_p3_size(const void* thr, const void* aux, const void* state, void* bits, int B, int P,
                 int L, int threads, int smem, void* stream) {
  static int allowed[kMaxDevices];
  const int rc =
      prepare_walk(p3_kernel<false>, allowed, L, threads, smem, p3_layout(L, false).total);
  if (rc) return rc;
  p3_kernel<false><<<walk_grid(B), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(thr), static_cast<const int*>(aux), static_cast<const int*>(state),
      nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<int*>(bits), nullptr, nullptr,
      nullptr, B, P, 0, L);
  return static_cast<int>(cudaGetLastError());
}

int ulcx_p3_materialize(const void* aux, const void* state, const void* coef, const void* ampn,
                        const void* hfamp, const void* hfmeta, const void* hdr, void* bits,
                        void* words, void* freg, void* fwc, int B, int P, int n_words, int L,
                        int threads, int smem, void* stream) {
  static int allowed[kMaxDevices];
  const int rc =
      prepare_walk(p3_kernel<true>, allowed, L, threads, smem, p3_layout(L, true).total);
  if (rc) return rc;
  p3_kernel<true><<<walk_grid(B), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      nullptr, static_cast<const int*>(aux), static_cast<const int*>(state),
      static_cast<const float*>(coef), static_cast<const float*>(ampn),
      static_cast<const float*>(hfamp), static_cast<const int*>(hfmeta),
      static_cast<const int*>(hdr), static_cast<int*>(bits), static_cast<int*>(words),
      static_cast<int*>(freg), static_cast<int*>(fwc), B, P, n_words, L);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
