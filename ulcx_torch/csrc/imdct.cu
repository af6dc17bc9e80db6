// The batched inverse transform for Hopper (sm_90a): one kernel, one row
// (stream, channel) a CTA.
//
// imdct_kernel replaces no TPU kernel. ulcx and the port both write this
// step in plain tensor code (codec/transform_batched.py, imdct_plain):
// every candidate subblock of each of the four size classes through one
// dense DCT-IV product a class (four [B, C, N] planes, O(S^2) each,
// ~258 GFLOP at B = 8192, C = 2, N = 2048, although a row's active
// subblocks tile its N coefficients and a long block uses class 0
// alone), then the windows and the lap (imdct_lap_plain). This kernel
// reads a row's coefficients and lap once into shared memory, takes the
// DCT-IV of the active subblocks of its window pattern there by an
// S/2-point FFT each (dct4.cuh, O(S log S)), and from there writes the
// PCM, the new lap and the stream's last subblock size.
//
// Layouts (the wrapper in codec/transform_batched.py checks them):
//   coefs     [B, C, N] f32, lap [B, C, N/2] f32
//   wc, prev_last_ss, last_ss  [B] int32
//   tables    kTableInts int32: transform_batched.lap_tables, per window
//             pattern the candidates' activity, left transient flag,
//             previous subblock's class shift and next active candidate
//             ([16][15] each), first and last active candidate ([16]),
//             and each candidate's class shift ([15])
//   win       2 N - 2 f32: transform_batched.lap_windows, the sine of
//             every even power-of-two overlap o = 2 .. N at offset o - 2
//   tw        17 N / 8 float2: transform_batched.dct4_twiddles (dct4.cuh)
//   pcm       [B, C, N] f32, new_lap [B, C, N/2] f32
// Warp 0 first computes the row's 15 left and right overlaps (the rules
// of transform_batched.boundary_overlaps_batched) and its subblocks'
// classes into shared memory, while every thread's first loads are in
// flight.
//
// Each output is then imdct_lap_plain's sum, in its order and with its
// float32 operations: the previous block's term (the lap gathered around
// fs = N/2 - prev_last_ss/2, times the flipped rise of the first
// subblock's overlap), then for class 0 to 3 the second half of frame
// i-1 and the first half of frame i, each a half-spectrum value read
// through imdct_expand's index map times its window value. Only active
// candidates contribute, and the plane holds exactly their half-spectra
// at their own offsets, so one plane serves every class. Products and
// sums are __fmul_rn / __fadd_rn, so nvcc cannot contract them into an
// FMA the plain version does not have. A window value is rise_window's 0
// or 1 by the same comparisons, else its sine: read from the window
// table, which the plain version's own float32 ops computed on the card
// (rise_window(o, o) takes over a window of overlap o the values that
// rise_window(len, o) takes over its transition), or for any other
// overlap (o = 1, an odd prev_last_ss) computed by rise_window's sequence
// (start, t, clamp, sinf of pi/2 * t), built without --use_fast_math so
// that sinf is the accurate one torch.sin calls. So, given the same
// half-spectra, the outputs are the plain version's bit for bit; the
// half-spectra themselves are the FFT's, within float32 rounding of the
// dense product's (not its bits: the sums run in another order). A term
// whose window selects 0 (an inactive candidate, the last candidate's
// right half, samples before a rise) is skipped instead of added as a
// signed zero; an overlap of 0 selects 0 or 1 everywhere, so nothing
// divides by it.
//
// Bound: bytes. Per row the kernel reads N coefficients and N/2 lap
// floats and writes N PCM samples and N/2 lap floats: 12 N bytes, 402.7
// MB at B = 8192, C = 2, N = 2048, 0.120 ms at 3.35 TB/s. Every global
// read and write is coalesced, the reads 16 bytes a thread with
// kLoadBatch of them in flight; the window and twiddle tables (51 KB at
// N = 2048) come from L1 or L2.

#include <climits>

#include <cuda_runtime.h>

#include "dct4.cuh"

namespace {

constexpr int kCands = 15;
constexpr int kClasses = 4;
// A CTA takes one row. Up to kSmallMaxN: kSmallThreads threads, at most
// 64 K / (kSmallThreads kSmallMinCtas) = 40 registers each, and FFT passes
// of kSmallStages radix-2 stages (dct4.cuh); above: kLargeThreads, one or
// two CTAs an SM by their shared memory, passes of kLargeStages.
constexpr int kSmallThreads = 256;
constexpr int kSmallMinCtas = 6;
constexpr int kSmallStages = 2;
constexpr int kSmallMaxN = 4096;
constexpr int kLargeThreads = 1024;
constexpr int kLargeStages = 3;
constexpr int kLoadBatch = 2;  // 16-byte loads a thread keeps in flight
// tables: offsets of each part, as transform_batched.lap_tables packs them
constexpr int kAct = 0;
constexpr int kLFlag = kAct + 16 * kCands;
constexpr int kLPrev = kLFlag + 16 * kCands;
constexpr int kNext = kLPrev + 16 * kCands;
constexpr int kFirst = kNext + 16 * kCands;
constexpr int kLast = kFirst + 16;
constexpr int kCShift = kLast + 16;
constexpr int kTableInts = kCShift + kCands;
constexpr float kHalfPi = 1.5707963267948966f;  // float32(math.pi / 2), as torch rounds it

constexpr int kInline = INT_MIN;

// ops.mdct.rise_window's window start, len/2 - overlap/2, in float32
__device__ __forceinline__ float rise_start(int len, int overlap) {
  return __fsub_rn(static_cast<float>(len / 2), __fmul_rn(static_cast<float>(overlap), 0.5f));
}

// A rise window of one overlap o: 0 before its start, a sine over o
// samples, 1 after. As ints: sample j is 0 for j < lo (j < start) and 1
// for j >= hi (j >= start + o). The sine of an even power-of-two o lies
// in the window table at o - 2 (transform_batched.lap_windows), so
// sample j reads win[base + j]; any other overlap computes it (base
// kInline).
struct Rise {
  int lo, hi, base, o;
};

__device__ __forceinline__ Rise make_rise(int len, int overlap) {
  const float start = rise_start(len, overlap);
  const float stop = __fadd_rn(start, static_cast<float>(overlap));
  const bool tabled = overlap >= 2 && (overlap & (overlap - 1)) == 0;
  return {static_cast<int>(ceilf(start)), static_cast<int>(ceilf(stop)),
          tabled ? overlap - 2 - (len / 2 - overlap / 2) : kInline, overlap};
}

// ops.mdct.rise_window(len, o)'s sine at sample j, as it computes it in float32
__device__ __noinline__ float rise_sine(int j, int len, int overlap) {
  float t = __fdiv_rn(__fadd_rn(__fsub_rn(static_cast<float>(j), rise_start(len, overlap)), 0.5f),
                      static_cast<float>(overlap));
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  return sinf(__fmul_rn(kHalfPi, t));
}

// ops.mdct.rise_window(len, r's overlap)[j]
__device__ __forceinline__ float rise_at(const Rise& r, int j, int len,
                                         const float* __restrict__ win) {
  if (j < r.lo) return 0.0f;
  if (j >= r.hi) return 1.0f;
  return r.base != kInline ? __ldg(win + r.base + j) : rise_sine(j, len, r.o);
}

// boundary_overlaps_batched's o_left of candidate k
__device__ __forceinline__ int overlap_left(const int* tab, int pat, int k, int scale, int n,
                                            int prev_ss) {
  const int size = n >> tab[kCShift + k];
  const int l_nom = size >> (tab[kLFlag + pat * kCands + k] == 1 ? scale : 0);
  const int l_prev = tab[kLPrev + pat * kCands + k];
  return min(l_nom, l_prev >= 0 ? n >> l_prev : prev_ss);
}

// What warp 0 of a CTA works out for its row before the outputs: the
// candidates' windows, the activity masks, the previous block's term, the
// new lap's split and the subblocks' classes.
struct LapRow {
  Rise left[kCands], right[kCands], prev;
  int act, right_act, fs, live_end, last_cls, f_new, classes;
  int class_mask;  // bit c: some candidate of class c is active
};

__device__ __forceinline__ void lap_setup(LapRow& s, long long row, int C, int N,
                                          const int* __restrict__ wc,
                                          const int* __restrict__ prev_last_ss,
                                          const int* __restrict__ tab, int* __restrict__ last_ss) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int b = static_cast<int>(row / C);
  const int h = N >> 1;
  const int w = wc[b], pss = prev_last_ss[b];
  const int pat = (w >> 4) & 15, scale = w & 7;
  const int last = tab[kLast + pat];
  bool act = false;
  if (lane < kCands) {
    const int ss = N >> tab[kCShift + lane];
    act = tab[kAct + pat * kCands + lane] == 1;
    const int o_l = overlap_left(tab, pat, lane, scale, N, pss);
    const int nxt = tab[kNext + pat * kCands + lane];
    s.left[lane] = make_rise(ss, o_l);
    s.right[lane] = make_rise(ss, min(overlap_left(tab, pat, nxt, scale, N, pss), ss));
  }
  const unsigned act_mask = __ballot_sync(0xffffffffu, act);
  const unsigned right_mask = __ballot_sync(0xffffffffu, act && lane != last);
  if (lane == 0) {
    const int first = tab[kFirst + pat];
    const int last_cls = tab[kCShift + last];
    const int lss = N >> last_cls;
    const bool known = pss == N || pss == (N >> 1) || pss == (N >> 2) || pss == (N >> 3);
    const int fs = h - pss / 2;
    s.act = static_cast<int>(act_mask);
    s.right_act = static_cast<int>(right_mask);
    int class_mask = 0;  // a class adds terms only through its active candidates
    for (int c = 0; c < kClasses; ++c)
      if (act_mask & (((1u << (1 << c)) - 1) << ((1 << c) - 1))) class_mask |= 1 << c;
    s.class_mask = class_mask;
    s.fs = fs;
    s.live_end = known ? N - fs : 0;
    s.last_cls = last_cls;
    s.f_new = h - lss / 2;
    s.classes = ulcx_dct4::eighth_classes(static_cast<int>(act_mask));
    s.prev = make_rise(N, overlap_left(tab, pat, first, scale, N, pss));
    if (row % C == 0) last_ss[b] = lss;
  }
}

// Every output of one row, kCta apart from the thread's own: q < N is
// PCM sample q, q >= N lap value q - N. `spec` holds the row's plane of
// half-spectra (dct4.cuh), `lap_row` its lap, both in shared memory.
template <int kCta>
__device__ __forceinline__ void lap_outputs(const LapRow& s, const float2* spec,
                                            const float* lap_row, const float* __restrict__ win,
                                            float* __restrict__ pcm_row,
                                            float* __restrict__ lap_out, int N, int log_n) {
  const int h = N >> 1;
  const int act = s.act, right_act = s.right_act, fs = s.fs, live_end = s.live_end;
  const int f_new = s.f_new, class_mask = s.class_mask;
  // lap value jh >= f_new: the last subblock's unwindowed half-spectrum
  // value jh - f_new, which lies at N - lss + (jh - f_new) in the plane
  const int last_off = N - (N >> s.last_cls) - f_new;
  for (int q = threadIdx.x; q < N + h; q += kCta) {
    if (q >= N + f_new) {
      lap_out[q - N] = ulcx_dct4::plane_at(spec, last_off + q - N);
      continue;
    }
    float acc = 0.0f;
    if (q < live_end) {  // q < N: the previous block's deferred term
      const float w = rise_at(s.prev, N - 1 - q, N, win);
      if (w != 0.0f) {
        const int src = q < fs ? q : (q < h ? h - 1 - q + fs : q - h + fs);
        acc = __fadd_rn(acc, __fmul_rn(lap_row[src], w));
      }
    }
#pragma unroll
    for (int cls = 0; cls < kClasses; ++cls) {
      if (!((class_mask >> cls) & 1)) continue;  // no candidate of the class adds a term
      const int lss = log_n - cls, ss = 1 << lss, hs = ss >> 1;
      const int rel = q - (h - hs);  // frame i of the class starts at h - ss/2 + i ss
      if (rel < 0 || rel >= N) continue;
      const int i = rel >> lss, m = rel & (ss - 1);
      const int k = (1 << cls) - 1 + i;
      if (i > 0 && ((right_act >> (k - 1)) & 1)) {  // frame i-1's second half
        const float w = rise_at(s.right[k - 1], ss - 1 - m, ss, win);
        if (w != 0.0f) {
          const float x = ulcx_dct4::plane_at(spec, (i - 1) * ss + (m < hs ? hs - 1 - m : m - hs));
          acc = __fadd_rn(acc, __fmul_rn(x, w));
        }
      }
      if ((act >> k) & 1) {  // frame i's first half
        const float w = rise_at(s.left[k], m, ss, win);
        if (w != 0.0f) {
          const float x = m < hs ? -ulcx_dct4::plane_at(spec, i * ss + hs + m)
                                 : ulcx_dct4::plane_at(spec, i * ss + 3 * hs - 1 - m);
          acc = __fadd_rn(acc, __fmul_rn(x, w));
        }
      }
    }
    if (q < N) {
      pcm_row[q] = acc;
    } else {
      lap_out[q - N] = acc;
    }
  }
}

// Float2 values of shared memory before the lap: the plane, rounded up to
// 16 bytes
__host__ __device__ constexpr int lap_offset(int n) { return (ulcx_dct4::row_float2(n) + 1) & ~1; }

__host__ __device__ constexpr int shared_bytes(int n) {
  return static_cast<int>(sizeof(float2)) * lap_offset(n) + static_cast<int>(sizeof(float)) * (n / 2);
}

// The whole inverse transform of one row (stream, channel) a CTA.
template <int kCta, int kMinCtas, int kPassStages>
__global__ void __launch_bounds__(kCta, kMinCtas) imdct_kernel(
    const float* __restrict__ coefs, const float* __restrict__ lap, const int* __restrict__ wc,
    const int* __restrict__ prev_last_ss, const int* __restrict__ tab,
    const float* __restrict__ win, const float2* __restrict__ tw, float* __restrict__ pcm,
    float* __restrict__ new_lap, int* __restrict__ last_ss, int C, int log_n) {
  extern __shared__ float4 s_dyn[];
  __shared__ LapRow s;
  float2* spec = reinterpret_cast<float2*>(s_dyn);
  const long long row = blockIdx.x;
  const int N = 1 << log_n, h = N >> 1, log_m = log_n - 1;
  float4* s_lap = reinterpret_cast<float4*>(spec + lap_offset(N));
  const float4* coefs4 = reinterpret_cast<const float4*>(coefs + row * N);
  const float4* lap4 = reinterpret_cast<const float4*>(lap + row * h);

  // The row's coefficients (N/4 16-byte loads) and lap (N/8), kLoadBatch
  // a thread in flight; the first batch goes out before warp 0's set-up.
  const int n_coef4 = N / 4, n_load = n_coef4 + N / 8;
  float4 x[kLoadBatch];
  auto load = [&](int i0) {
#pragma unroll
    for (int k = 0; k < kLoadBatch; ++k) {
      const int i = i0 + k * kCta;
      if (i < n_load) x[k] = i < n_coef4 ? __ldg(coefs4 + i) : __ldg(lap4 + (i - n_coef4));
    }
  };
  load(threadIdx.x);
  lap_setup(s, row, C, N, wc, prev_last_ss, tab, last_ss);
  __syncthreads();
  const int classes = s.classes;
  float* spec_f = reinterpret_cast<float*>(spec);
  for (int i0 = threadIdx.x; i0 < n_load; i0 += kLoadBatch * kCta) {
#pragma unroll
    for (int k = 0; k < kLoadBatch; ++k) {
      const int i = i0 + k * kCta;
      if (i >= n_load) break;
      if (i < n_coef4) {  // complex positions 2i and 2i + 1
        ulcx_dct4::load_pair(spec_f, classes, 2 * i, log_m, x[k].x, x[k].y);
        ulcx_dct4::load_pair(spec_f, classes, 2 * i + 1, log_m, x[k].z, x[k].w);
      } else {
        s_lap[i - n_coef4] = x[k];
      }
    }
    load(i0 + kLoadBatch * kCta);
  }
  __syncthreads();
  ulcx_dct4::dct4_row<kCta, kPassStages>(spec, classes, log_n, tw);
  lap_outputs<kCta>(s, spec, reinterpret_cast<const float*>(s_lap), win, pcm + row * N,
                    new_lap + row * h, N, log_n);
}

int log2_of(int n) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  return log_n;
}

}  // namespace

extern "C" {

// threads must be the kernel's for N (256 up to N = 4096, 1024 above),
// n_tables kTableInts, n_win 2 N - 2 (the window table's floats), n_tw
// 17 N / 8 (the twiddle table's complex values) and shared the kernel's
// dynamic shared memory (4.125 N bytes of half-spectra, 2 N of lap).
// Returns cudaErrorInvalidValue, launching nothing, for any other
// geometry or an empty or oversized batch; else cudaGetLastError() after
// the launch.
int ulcx_imdct(const void* coefs, const void* lap, const void* wc, const void* prev_last_ss,
               const void* tables, const void* win, const void* tw, void* pcm, void* new_lap,
               void* last_ss, int B, int C, int N, int threads, int n_tables, int n_win, int n_tw,
               int shared, void* stream) {
  const long long rows = static_cast<long long>(B) * C;
  const bool small = N <= kSmallMaxN;
  if (B < 1 || C < 1 || rows > 0x7fffffffLL || N < 16 || N > 32768 || (N & (N - 1)) ||
      threads != (small ? kSmallThreads : kLargeThreads) || n_tables != kTableInts ||
      n_win != 2 * N - 2 || n_tw != 17 * N / 8 || shared != shared_bytes(N))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel =
      small ? reinterpret_cast<const void*>(imdct_kernel<kSmallThreads, kSmallMinCtas, kSmallStages>)
            : reinterpret_cast<const void*>(imdct_kernel<kLargeThreads, 1, kLargeStages>);
  if (shared > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  int log_n = log2_of(N);
  void* args[] = {&coefs, &lap, &wc, &prev_last_ss, &tables, &win, &tw, &pcm, &new_lap, &last_ss,
                  &C, &log_n};
  const cudaError_t rc = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(rows)), dim3(threads),
                                          args, shared, static_cast<cudaStream_t>(stream));
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // extern "C"
