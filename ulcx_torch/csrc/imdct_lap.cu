// Windowing and lap of the batched inverse transform for Hopper (sm_90a).
//
// imdct_lap_kernel replaces no TPU kernel. ulcx and the port both write
// this step in plain tensor code (codec/transform_batched.py,
// imdct_lap_plain): after the four per-class DCT-IV products it expands
// every candidate subblock's half-spectrum to its 2S aliased samples,
// builds rise windows for every candidate, masks them by activity, adds
// the windowed halves into an [N + N/2] accumulator, gathers the
// previous block's deferred term from the lap, and reshuffles the new
// lap. On the card that was ~310 launches a decoded block, each
// [B, C, npos, 2S] or [B, npos, S] intermediate written to device memory
// and read back. This kernel computes the same values in one pass: it
// reads the four half-spectra and the lap and writes the PCM, the new
// lap and each stream's last subblock size.
//
// Layouts (the wrapper in codec/transform_batched.py checks them):
//   v0..v3    [B, C, N] f32  class c's 2^c half-spectra of N/2^c values,
//                            back to back (the DCT-IV products' output)
//   lap       [B, C, N/2] f32
//   wc, prev_last_ss, last_ss  [B] int32
//   tables    kTableInts int32: transform_batched.lap_tables, per window
//             pattern the candidates' activity, left transient flag,
//             previous subblock's class shift and next active candidate
//             ([16][15] each), first and last active candidate ([16]),
//             and each candidate's class shift ([15])
//   win       2 N - 2 f32: transform_batched.lap_windows, the sine of
//             every even power-of-two overlap o = 2 .. N at offset o - 2
//   pcm       [B, C, N] f32, new_lap [B, C, N/2] f32
// A row is one (stream, channel). A CTA takes `tile` outputs of one row:
// output q < N is PCM sample q, q >= N is lap value q - N. Warp 0 first
// computes the row's 15 left and right overlaps into shared memory (the
// rules of transform_batched.boundary_overlaps_batched), so no table op
// runs outside the kernel.
//
// Each output is the plain version's sum, in its order and with its
// float32 operations: the previous block's term (the lap gathered
// around fs = N/2 - prev_last_ss/2, times the flipped rise of the first
// subblock's overlap), then for class 0 to 3 the second half of frame
// i-1 and the first half of frame i, each a half-spectrum value read
// through imdct_expand's index map times its window value. Products and
// sums are __fmul_rn / __fadd_rn, so nvcc cannot contract them into an
// FMA the plain version does not have. A window value is rise_window's 0
// or 1 by the same comparisons, else its sine: read from the window
// table, which the plain version's own float32 ops computed on the card
// (rise_window(o, o) takes over a window of overlap o the values that
// rise_window(len, o) takes over its transition), or for any other
// overlap (o = 1, an odd prev_last_ss) computed by rise_window's
// sequence (start, t, clamp, sinf of pi/2 * t), built without
// --use_fast_math so that sinf is the accurate one torch.sin calls. So
// the outputs equal the plain version's bit for bit on the card. A term
// whose window selects 0 (an inactive candidate, the last candidate's
// right half, samples before a rise) is skipped instead of added as a
// signed zero; an overlap of 0 selects 0 or 1 everywhere, so nothing
// divides by it.
//
// Bound: bytes. Per row the active candidates' spectra tile the block,
// so the kernel needs N + N/2 floats read (the spectra it uses and the
// lap) and N + N/2 written: 12 N bytes. At B = 8192, C = 2, N = 2048
// that is 402.7 MB, 0.120 ms at 3.35 TB/s (all four classes' spectra
// counted as read: 805.3 MB, 0.240 ms). Every read and write is
// coalesced: neighbouring threads take neighbouring outputs, whose
// spectrum and lap reads run over neighbouring addresses (in reverse
// order in the reversed quarters). The second read of each spectrum
// value (it feeds the first half of its frame and the second half of
// the same frame one subblock later) comes from L1 or L2, and so do the
// window table's values.
//
// What bounds it is latency: a few dependent loads an output and little
// arithmetic. The first design computed each window value inline (an
// IEEE division and a sinf, 48 registers) and ran at 0.40 ms at that
// shape; the table and 8 CTAs of 256 threads an SM (at most 32
// registers) take it to 0.28 ms, 43 % of the bound (PERF.md §6).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kCands = 15;
constexpr int kClasses = 4;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 8;  // CTAs an SM: 2,048 threads, at most 32 registers each
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

__global__ void __launch_bounds__(kThreads, kMinBlocks) imdct_lap_kernel(
    const float* __restrict__ v0, const float* __restrict__ v1, const float* __restrict__ v2,
    const float* __restrict__ v3, const float* __restrict__ lap, const int* __restrict__ wc,
    const int* __restrict__ prev_last_ss, const int* __restrict__ tab,
    const float* __restrict__ win, float* __restrict__ pcm,
    float* __restrict__ new_lap, int* __restrict__ last_ss, int C, int N, int log_n, int tile) {
  __shared__ Rise s_left[kCands], s_right[kCands];
  __shared__ Rise s_prev;
  __shared__ int s_act, s_right_act, s_fs, s_live_end, s_last_cls, s_f_new;

  const size_t row = blockIdx.x;
  const int b = static_cast<int>(row / C);
  const int h = N >> 1;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int w = wc[b], pss = prev_last_ss[b];
    const int pat = (w >> 4) & 15, scale = w & 7;
    const int last = tab[kLast + pat];
    bool act = false;
    if (lane < kCands) {
      const int ss = N >> tab[kCShift + lane];
      act = tab[kAct + pat * kCands + lane] == 1;
      const int o_l = overlap_left(tab, pat, lane, scale, N, pss);
      const int nxt = tab[kNext + pat * kCands + lane];
      s_left[lane] = make_rise(ss, o_l);
      s_right[lane] = make_rise(ss, min(overlap_left(tab, pat, nxt, scale, N, pss), ss));
    }
    const unsigned act_mask = __ballot_sync(0xffffffffu, act);
    const unsigned right_mask = __ballot_sync(0xffffffffu, act && lane != last);
    if (lane == 0) {
      const int first = tab[kFirst + pat];
      const int last_cls = tab[kCShift + last];
      const int lss = N >> last_cls;
      const bool known = pss == N || pss == (N >> 1) || pss == (N >> 2) || pss == (N >> 3);
      const int fs = h - pss / 2;
      s_act = static_cast<int>(act_mask);
      s_right_act = static_cast<int>(right_mask);
      s_fs = fs;
      s_live_end = known ? N - fs : 0;
      s_last_cls = last_cls;
      s_f_new = h - lss / 2;
      s_prev = make_rise(N, overlap_left(tab, pat, first, scale, N, pss));
      if (blockIdx.y == 0 && row % C == 0) last_ss[b] = lss;
    }
  }
  __syncthreads();

  const int act = s_act, right_act = s_right_act, fs = s_fs, live_end = s_live_end;
  const int f_new = s_f_new, last_cls = s_last_cls;
  const float* vrow[kClasses] = {v0 + row * N, v1 + row * N, v2 + row * N, v3 + row * N};
  const float* lap_row = lap + row * h;
  const float* v_last = last_cls == 0 ? vrow[0] : last_cls == 1 ? vrow[1]
                        : last_cls == 2 ? vrow[2] : vrow[3];
  // lap value jh >= f_new: the last subblock's unwindowed half-spectrum
  // value jh - f_new, which lies at N - lss + (jh - f_new) in its class's row
  const int last_off = N - (N >> last_cls) - f_new;
  float* pcm_row = pcm + row * N;
  float* lap_out = new_lap + row * h;

  const int q_end = min(static_cast<int>(blockIdx.y + 1) * tile, N + h);
  for (int q = blockIdx.y * tile + threadIdx.x; q < q_end; q += kThreads) {
    if (q >= N + f_new) {
      lap_out[q - N] = v_last[last_off + q - N];
      continue;
    }
    float acc = 0.0f;
    if (q < live_end) {  // q < N: the previous block's deferred term
      const float w = rise_at(s_prev, N - 1 - q, N, win);
      if (w != 0.0f) {
        const int src = q < fs ? q : (q < h ? h - 1 - q + fs : q - h + fs);
        acc = __fadd_rn(acc, __fmul_rn(lap_row[src], w));
      }
    }
#pragma unroll
    for (int cls = 0; cls < kClasses; ++cls) {
      const int lss = log_n - cls, ss = 1 << lss, hs = ss >> 1;
      const int rel = q - (h - hs);  // frame i of the class starts at h - ss/2 + i ss
      if (rel < 0 || rel >= N) continue;
      const int i = rel >> lss, m = rel & (ss - 1);
      const int k = (1 << cls) - 1 + i;
      const float* v = vrow[cls];
      if (i > 0 && ((right_act >> (k - 1)) & 1)) {  // frame i-1's second half
        const float w = rise_at(s_right[k - 1], ss - 1 - m, ss, win);
        if (w != 0.0f) {
          const float x = v[(i - 1) * ss + (m < hs ? hs - 1 - m : m - hs)];
          acc = __fadd_rn(acc, __fmul_rn(x, w));
        }
      }
      if ((act >> k) & 1) {  // frame i's first half
        const float w = rise_at(s_left[k], m, ss, win);
        if (w != 0.0f) {
          const float x = m < hs ? -v[i * ss + hs + m] : v[i * ss + 3 * hs - 1 - m];
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

}  // namespace

extern "C" {

// tile: outputs a CTA takes (transform_batched.lap_geometry); threads
// must be kThreads, n_tables kTableInts and n_win 2 N - 2 (the window
// table's floats). Returns cudaErrorInvalidValue, launching nothing, for
// any other geometry or an empty or oversized batch; else
// cudaGetLastError() after the launch.
int ulcx_imdct_lap(const void* v0, const void* v1, const void* v2, const void* v3,
                   const void* lap, const void* wc, const void* prev_last_ss, const void* tables,
                   const void* win, void* pcm, void* new_lap, void* last_ss, int B, int C, int N,
                   int tile, int threads, int n_tables, int n_win, void* stream) {
  const long long rows = static_cast<long long>(B) * C;
  if (B < 1 || C < 1 || rows > 0x7fffffffLL || N < 16 || N > 32768 || (N & (N - 1)) ||
      threads != kThreads || tile < 1 || n_tables != kTableInts || n_win != 2 * N - 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int log_n = 0;
  while ((1 << log_n) < N) ++log_n;
  const dim3 grid(static_cast<unsigned>(rows), (N + N / 2 + tile - 1) / tile);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  imdct_lap_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v0), static_cast<const float*>(v1),
      static_cast<const float*>(v2), static_cast<const float*>(v3),
      static_cast<const float*>(lap), static_cast<const int*>(wc),
      static_cast<const int*>(prev_last_ss), static_cast<const int*>(tables),
      static_cast<const float*>(win), static_cast<float*>(pcm), static_cast<float*>(new_lap), static_cast<int*>(last_ss), C, N,
      log_n, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
