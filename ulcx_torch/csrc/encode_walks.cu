// Encode-pass walks of the ULC bitstream for Hopper (sm_90a).
//
// Four kernels, one per Pallas call of ulcx/bitstream/pallas_encode3.py:
//   p1_kernel            <- _p1 (forward zone scan; pallas_call at :546)
//   p2_kernel            <- _p2 (reverse backfill; :559)
//   p3_kernel<false>     <- _p3, size-only (:587)
//   p3_kernel<true>      <- _p3, materialize (:601)
// Each computes what its Pallas kernel computes, not its block
// structure: one thread per (stream, candidate) walks all P positions
// serially, so the TPU grid's chunk loop, its VMEM scratch carry and
// the unrolled chunk bodies have no counterpart here.
//
// Layouts (the wrappers in bitstream/encode_kernels.py check them):
//   per-position planes  [P, B]    stream fastest (key, coef, aux, thr)
//   line planes          [P/2, B]  read at p >> 1 (ampn, hfamp, hfmeta)
//   per-candidate        [B, 8]    thread tid = b * 8 + cand (t, c, bits)
//   state planes         [P, B, 8] (s12, state): a warp writes 128
//                                   contiguous bytes per position
//   words                [B, 8, n_words]
//
// Bound: each walk is a serial, latency-bound recurrence over P with one
// thread per (stream, candidate). At B = 512 that is 4096 threads, about
// 2 % of the card's 270,336 resident-thread slots (132 SMs x 2048), so
// the card idles while a few warps per SM step through P dependent
// iterations. This first design does nothing about that yet (no
// warp-cooperative walk, no overlap across ladder rounds); filling the
// card is later work (PERF.md, open questions).
//
// Numerics: built without --use_fast_math, so logf/sqrtf are the
// accurate ones and denormals are not flushed behind the code's back
// (the zone scan flushes denormal magnitudes itself, as the TPU
// reference does). Float products and sums use
// the _rn intrinsics so that nvcc cannot contract them into FMAs: the
// plain PyTorch versions round each operation separately.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCand = 8;
constexpr int kSent = 1 << 20;   // "no position" sentinel (> any p)
// one warp per block: B = 512 gives 128 blocks, spread over 128 SMs
constexpr int kThreads = 32;
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

// Forward zone scan: running min/max of |coef| over kept positions,
// reset at segment starts, zone split when max > 4 * min. Emits the
// zone quantizer index qi | split << 5.
__global__ void p1_kernel(const int* __restrict__ t, const int* __restrict__ c,
                          const int* __restrict__ key, const float* __restrict__ coef,
                          const int* __restrict__ aux, int* __restrict__ s12, int B, int P) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * kCand) return;
  const int b = tid / kCand;
  const int tt = t[tid], cc = c[tid];
  float qmin = 1000.0f, qmax = -1000.0f;
  for (int p = 0; p < P; ++p) {
    const size_t pb = static_cast<size_t>(p) * B + b;
    // denormal magnitudes count as zero, as on the TPU the zone logic
    // was written for (it flushes them); IEEE compares would split
    // zones at max(0, denormal) > 4 * 0
    float a = fabsf(coef[pb]);
    if (a < kFltMin) a = 0.0f;
    const bool kept = kept_at(key[pb], tt, cc, p);
    if ((aux[pb] >> 16) & 1) {
      qmin = 1000.0f;
      qmax = -1000.0f;
    }
    const float nmin = fminf(qmin, a), nmax = fmaxf(qmax, a);
    const bool split = kept && (nmax > __fmul_rn(nmin, 4.0f));
    if (kept) {
      qmin = split ? a : nmin;
      qmax = split ? a : nmax;
    }
    // clip in float before the int conversion: log of a flushed or zero
    // maximum is -inf and the quotient +inf
    float x = floorf(__fsub_rn(kBqA, __fmul_rn(kInvLn2, logf(fmaxf(qmax, 1e-38f)))));
    x = fminf(fmaxf(x, 5.0f), 31.0f);
    s12[pb * kCand + (tid % kCand)] = static_cast<int>(x) | (static_cast<int>(split) << 5);
  }
}

// Reverse backfill: zone ends and each zone's quantizer; a kept
// position is coded when q >= qmin(|coef|, 2.5) from the packed
// threshold plane. Emits next_coded_pos (16b) | q << 16 | coded << 21.
__global__ void p2_kernel(const int* __restrict__ t, const int* __restrict__ c,
                          const int* __restrict__ key, const int* __restrict__ thr,
                          const int* __restrict__ aux, const int* __restrict__ s12,
                          int* __restrict__ state, int B, int P) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * kCand) return;
  const int b = tid / kCand, cand = tid % kCand;
  const int tt = t[tid], cc = c[tid];
  int nk = kSent, nk_split = 0, cur_qi = 31, q_next = 31, ncp = kSent;
  for (int p = P - 1; p >= 0; --p) {
    const size_t pb = static_cast<size_t>(p) * B + b;
    const int segdelta = aux[pb] & 0xFFFF;
    const bool kept = kept_at(key[pb], tt, cc, p);
    const int s = s12[pb * kCand + cand];
    if (kept && (nk >= kSent || nk_split == 1 || nk >= p + segdelta)) cur_qi = s & 0x1F;
    const bool coded = kept && cur_qi >= (thr[pb] & 63);
    if (coded) {
      q_next = cur_qi;
      ncp = p;
    }
    state[pb * kCand + cand] =
        min(max(ncp, 0), 0xFFFF) | (q_next << 16) | (static_cast<int>(coded) << 21);
    if (kept) {
      nk = p;
      nk_split = (s >> 5) & 1;
    }
  }
}

// Forward emission walk. Each position yields one of five events (coded
// coefficient, rescue pair, noise run, short zero run, long zero run),
// plus quantizer-change tokens and one segment-tail token (HF extension,
// stop, or zero tail). Size mode counts nybbles from the packed
// threshold plane; materialize mode reads the value planes, packs the
// nybbles through a u32 shift register and stores each completed word
// at its index. The final partial register goes to index wcount.
template <bool kMat>
__global__ void p3_kernel(const int* __restrict__ thr, const int* __restrict__ aux,
                          const int* __restrict__ state, const float* __restrict__ coef,
                          const float* __restrict__ ampn, const float* __restrict__ hfamp,
                          const int* __restrict__ hfmeta, const int* __restrict__ hdr,
                          int* __restrict__ bits_out, int* __restrict__ words,
                          int* __restrict__ freg_out, int* __restrict__ fwc_out, int B, int P,
                          int n_words) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * kCand) return;
  const int b = tid / kCand, cand = tid % kCand;
  int covered = 0, prev_q = -1, bits = 0, tail_done = 0;
  uint32_t reg = 0;
  int fill = 0, wcount = 0;
  int* my_words = nullptr;
  if (kMat) {
    const int h = hdr[b];
    fill = h >> 8;
    reg = static_cast<uint32_t>(fill == 2 ? (h & 0xFF) : (h & 0xF));
    my_words = words + static_cast<size_t>(tid) * n_words;
  }
  for (int p = 0; p < P; ++p) {
    const size_t pb = static_cast<size_t>(p) * B + b;
    const size_t lb = static_cast<size_t>(p >> 1) * B + b;
    const int ax = aux[pb];
    const int segdelta = ax & 0xFFFF;
    const int srow = state[pb * kCand + cand];
    const int ncp = srow & 0xFFFF;
    const int qq = (srow >> 16) & 0x1F;
    const bool is_code = (srow >> 21) & 1;
    const bool is_tail = (ncp - p) >= segdelta;
    const bool gp = !is_code && !is_tail;
    const int s = qq - 5;
    const int ext_q = s >= 14;
    const int z_r = min(max(ncp - p, 0), kSent);

    bool resc_ok, noise_ok;
    int th = 0, qn1 = 0, qn2 = 0, nq_est = 0;
    if (kMat) {
      const float scale = exp2i(qq);
      const float c0 = coef[pb];
      const float c1 = coef[static_cast<size_t>(min(p + 1, P - 1)) * B + b];
      qn1 = min(cq_unsigned(__fmul_rn(fabsf(c0), scale)), 7);
      if (c0 < 0.0f) qn1 = -qn1;
      qn2 = min(cq_unsigned(__fmul_rn(fabsf(c1), scale)), 7);
      if (c1 < 0.0f) qn2 = -qn2;
      const float amp = ampn[lb];
      nq_est = amp > 0.0f ? min(cq_unsigned(__fmul_rn(amp, scale)), 8) : 0;
      resc_ok = abs(qn1) > 1 && (z_r < 2 || abs(qn2) > 1);
      noise_ok = nq_est > 0;
    } else {
      th = thr[pb];
      resc_ok = qq >= (th & 63) && (z_r < 2 || qq >= ((th >> 6) & 63));
      noise_ok = qq >= ((th >> 12) & 63);
    }
    const bool do_resc = gp && z_r <= 2 && resc_ok;
    const bool do_noise = gp && !do_resc && z_r >= 16 && noise_ok;
    const bool do_zs = gp && !do_resc && !do_noise && z_r < 33;
    const int run_n = do_resc    ? z_r
                      : do_noise ? min(z_r, 527)
                      : do_zs    ? min(z_r, 16)
                                 : min(z_r, 288);
    const int run_cnt = do_resc ? z_r : do_noise ? 4 : do_zs ? 2 : 3;

    if ((ax >> 16) & 1) {
      prev_q = -1;
      tail_done = 0;
    }
    const bool act = p >= covered && (is_code || gp);
    const bool coded_ev = act && is_code;
    const int lead = prev_q >= 0;
    const bool need_q = act && qq != prev_q;
    const int q_cnt = need_q ? 1 + ext_q + lead : 0;
    const int cnt = act ? q_cnt + (is_code ? 1 : run_cnt) : 0;
    const int new_covered = act ? (is_code ? p + 1 : p + run_n) : covered;
    const int new_prev_q = need_q ? qq : prev_q;

    // tail token: fires at the first in-segment position with nothing
    // coded ahead
    const bool tail_ev = !is_code && is_tail && tail_done == 0;
    const int n_tail = segdelta;
    const bool pq_valid = prev_q >= 0;
    bool hfok, hf_amp_ok;
    int nq_hf = 0, dec_t = 0;
    if (kMat) {
      const int meta = hfmeta[lb];
      hfok = (meta >> 8) == 1;
      dec_t = meta & 0xFF;
      const float v = __fmul_rn(__fmul_rn(hfamp[lb], exp2i(prev_q)), 4.0f);
      nq_hf = min(cq_unsigned(v), 16);
      hf_amp_ok = nq_hf > 0;
    } else {
      hfok = (th >> 24) & 1;
      hf_amp_ok = prev_q >= ((th >> 18) & 63);
    }
    const bool do_hf = tail_ev && pq_valid && n_tail >= 16 && hfok && hf_amp_ok;
    const bool do_stop = tail_ev && n_tail > 4 && !do_hf;
    const bool do_zt = tail_ev && n_tail > 0 && n_tail <= 4;
    const int cnt_tail = do_hf ? 5 : do_stop ? (pq_valid ? 3 : 2) : do_zt ? 2 : 0;
    if (tail_ev) tail_done = 1;
    bits += cnt + cnt_tail;

    if (kMat) {
      uint32_t pos_packed;
      if (tail_ev) {
        if (do_hf) {
          pos_packed = 0xFFu | (static_cast<uint32_t>((nq_hf - 1) & 0xF) << 8) |
                       (static_cast<uint32_t>((dec_t >> 4) & 0xF) << 12) |
                       (static_cast<uint32_t>(dec_t & 0xF) << 16);
        } else if (do_stop) {
          pos_packed = pq_valid ? (0xFu | (0xEu << 4) | (0xFu << 8)) : (0xEu | (0xFu << 4));
        } else {
          pos_packed = do_zt ? static_cast<uint32_t>(min(max(n_tail - 1, 0), 0xF)) << 4 : 0u;
        }
      } else {
        const int qv0 = lead ? 0xF : (ext_q ? 0xE : s);
        const int qv1 = lead ? (ext_q ? 0xE : s) : s - 14;
        const int qv2 = s - 14;
        const int v_noise = run_n - 16, v_long = run_n - 33;
        const int t0 = (coded_ev || do_resc) ? (qn1 & 0xF) : do_noise ? 0x8 : do_zs ? 0x0 : 0x1;
        const int t1 = do_resc     ? (qn2 & 0xF)
                       : do_noise ? ((v_noise >> 5) & 0xF)
                       : do_zs    ? (run_n - 1)
                                  : ((v_long >> 4) & 0xF);
        const int t2 = do_noise ? ((v_noise >> 1) & 0xF) : (v_long & 0xF);
        const int t3 = ((v_noise & 1) | ((nq_est - 1) << 1)) & 0xF;
        const uint32_t qpart = static_cast<uint32_t>((qv0 & 0xF) | ((qv1 & 0xF) << 4) |
                                                     ((qv2 & 0xF) << 8));
        const uint32_t tpart = static_cast<uint32_t>((t0 & 0xF) | ((t1 & 0xF) << 4) |
                                                     ((t2 & 0xF) << 8) | ((t3 & 0xF) << 12));
        const uint32_t qm = (1u << (4 * q_cnt)) - 1u;
        const uint32_t hm = (1u << (4 * cnt)) - 1u;  // cnt <= 7
        pos_packed = ((qpart & qm) | (tpart << (4 * q_cnt))) & hm;
      }
      // one u32 holds 8 nybbles; a position adds at most 7, so at most
      // one word completes per position
      const uint32_t full = reg | (pos_packed << (4 * fill));
      const int newfill = fill + cnt + cnt_tail;
      if (newfill >= 8) {
        if (wcount < n_words) my_words[wcount] = static_cast<int>(full);
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
  bits_out[tid] = bits;
  if (kMat) {
    if (wcount < n_words) my_words[wcount] = static_cast<int>(reg);
    freg_out[tid] = static_cast<int>(reg);
    fwc_out[tid] = wcount;
  }
}

inline int grid_for(int B) { return (B * kCand + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, allocates nothing, and returns cudaGetLastError() as an int.
extern "C" {

int ulcx_p1(const void* t, const void* c, const void* key, const void* coef, const void* aux,
            void* s12, int B, int P, void* stream) {
  p1_kernel<<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(t), static_cast<const int*>(c), static_cast<const int*>(key),
      static_cast<const float*>(coef), static_cast<const int*>(aux), static_cast<int*>(s12), B,
      P);
  return static_cast<int>(cudaGetLastError());
}

int ulcx_p2(const void* t, const void* c, const void* key, const void* thr, const void* aux,
            const void* s12, void* state, int B, int P, void* stream) {
  p2_kernel<<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(t), static_cast<const int*>(c), static_cast<const int*>(key),
      static_cast<const int*>(thr), static_cast<const int*>(aux), static_cast<const int*>(s12),
      static_cast<int*>(state), B, P);
  return static_cast<int>(cudaGetLastError());
}

int ulcx_p3_size(const void* thr, const void* aux, const void* state, void* bits, int B, int P,
                 void* stream) {
  p3_kernel<false><<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(thr), static_cast<const int*>(aux), static_cast<const int*>(state),
      nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<int*>(bits), nullptr, nullptr,
      nullptr, B, P, 0);
  return static_cast<int>(cudaGetLastError());
}

int ulcx_p3_materialize(const void* aux, const void* state, const void* coef, const void* ampn,
                        const void* hfamp, const void* hfmeta, const void* hdr, void* bits,
                        void* words, void* freg, void* fwc, int B, int P, int n_words,
                        void* stream) {
  p3_kernel<true><<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nullptr, static_cast<const int*>(aux), static_cast<const int*>(state),
      static_cast<const float*>(coef), static_cast<const float*>(ampn),
      static_cast<const float*>(hfamp), static_cast<const int*>(hfmeta),
      static_cast<const int*>(hdr), static_cast<int*>(bits), static_cast<int*>(words),
      static_cast<int*>(freg), static_cast<int*>(fwc), B, P, n_words);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
