// The inverse transform's DCT-IV for Hopper (sm_90a): each row's active
// subblocks in shared memory, by a complex FFT of half their length.
//
// A row (stream, channel) holds N coefficients that its window pattern
// splits into subblocks of S = N >> cls (cls 0..3), tiling the block at
// offsets that are multiples of S. Each subblock's half-spectrum is the
// unnormalised DCT-IV of its S coefficients,
//   v[k] = sum_n x[n] cos(pi/S (n + 1/2)(k + 1/2))
// (ops.dct.dct4_matmul's basis), and the row's plane of half-spectra is
// the subblocks' back to back: plane index i is coefficient i's.
//
// Per subblock, with M = S/2 (the identity of ops.dct's fact backend):
//   z[m] = (x[2m] + i x[S-1-2m]) * pre[m],     pre[m]  = e^{-i pi m / S}
//   F    = FFT_M(z)
//   T[j] = F[j] * post[j],                     post[j] = e^{-i pi (j + 1/4) / S}
//   v[2j] = Re T[j],   v[S-1-2j] = -Im T[j].
// The FFT is an in-place radix-2 decimation in time: the load writes z
// (untwiddled) in bit-reversed order, stage l = 1 .. log2 M joins pairs
// (p, p + L/2), L = 2^l, within blocks of L aligned to L,
//   a' = a + W_L^e b,  b' = a - W_L^e b,  e = p mod L/2,
// and leaves F in natural order. Every subblock of a row runs the same
// stage at once: the row's complex positions are the subblocks' M-point
// arrays back to back, each aligned to its own length, so a block of L
// positions lies inside one subblock or is made of whole smaller ones,
// which have no stage l (l > log2 of their M) and skip it. A pass does
// kPassStages stages on groups of 2^kPassStages points held in registers,
// so shared memory is read and written once a pass; the first pass
// multiplies each point by its pre-twiddle first.
//
// The twiddles are float32 tables computed in float64 on the host
// (transform_batched.dct4_twiddles): W_{N/2}^k for k < N/4 (a stage of
// a subblock of M points reads W_L^e = W_{N/2}^{e N/(2L)}), then per class
// its M pre- and M post-twiddles. Every product and sum is __fmul_rn /
// __fadd_rn / __fsub_rn, as float32 numpy computes it, so nvcc contracts
// nothing into an FMA and a transcription in numpy gives the same bits.
//
// Shared memory: a row is N/2 complex values, stored as float2 at
// pad(p) = p + p / 32, which spreads the bit-reversed writes of a warp
// over the banks; row_float2(N) values a row, 4.125 N bytes (132 KB at
// N = 32768).

#pragma once

#include <cuda_runtime.h>

namespace ulcx_dct4 {

__host__ __device__ constexpr int row_float2(int n) { return n / 2 + (n / 2 >> 5); }

__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

__device__ __forceinline__ int bit_reverse(int x, int bits) {
  return bits == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(x)) >> (32 - bits));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// Offset in the twiddle table of class cls's pre-twiddles: N/4 + 2 (N/2 +
// ... + N >> cls); its post-twiddles follow them, M = N >> (cls + 1) later.
__device__ __forceinline__ int pre_offset(int n, int cls) { return n / 4 + 2 * n - (2 * n >> cls); }

// The class of the subblock that holds complex position p of a row whose
// eighths' classes are packed two bits each in `classes` (eighth e at
// bits 2e, 2e + 1); log_m = log2(N/2).
__device__ __forceinline__ int class_at(int classes, int p, int log_m) {
  return (classes >> (2 * (p >> (log_m - 3)))) & 3;
}

// The packed classes of a pattern's eighths, from its activity mask over
// the 15 candidates (class c's 2^c candidates from bit 2^c - 1 on).
__device__ __forceinline__ int eighth_classes(int act) {
  int classes = 0;
  for (int e = 0; e < 8; ++e) {
    int cls = 0;
    for (int c = 3; c >= 0; --c)
      if ((act >> ((1 << c) - 1 + (e >> (3 - c)))) & 1) cls = c;
    classes |= cls << (2 * e);
  }
  return classes;
}

// Where the load puts complex position p's two coefficients of a row
// (float view `row` of its buffer): x[2p] is Re z[m] and x[2p + 1] is
// Im z[M-1-m] of p's subblock, m = p - its offset, and z[m] sits at m's
// bit reverse.
__device__ __forceinline__ void load_pair(float* row, int classes, int p, int log_m, float re,
                                          float im) {
  const int ls = log_m - class_at(classes, p, log_m), ms = 1 << ls;
  const int o = p & ~(ms - 1), rv = bit_reverse(p - o, ls);
  row[2 * pad(o + rv)] = re;
  row[2 * pad(o + ms - 1 - rv) + 1] = im;
}

// The DCT-IV of a row's active subblocks (packed eighths' `classes`) in
// shared memory, by all kCta threads of the CTA, after the load
// (load_pair, then a barrier). Ends synchronised: plane value i of the
// row is then plane_at(row, i).
template <int kCta, int kPassStages>
__device__ void dct4_row(float2* row, int classes, int log_n, const float2* __restrict__ tw) {
  const int log_m = log_n - 1, m_all = 1 << log_m, n = 1 << log_n;
  for (int l0 = 1; l0 <= log_m; l0 += kPassStages) {
    const int np = min(kPassStages, log_m - l0 + 1);  // stages of this pass
    const int h0 = 1 << (l0 - 1);
    for (int g = threadIdx.x; g < (m_all >> np); g += kCta) {
      const int j = g & (h0 - 1), base = ((g >> (l0 - 1)) << (l0 - 1 + np)) + j;
      float2 v[1 << kPassStages];
#pragma unroll
      for (int t = 0; t < (1 << kPassStages); ++t) {
        if (t >= (1 << np)) break;
        const int p = base + t * h0;
        v[t] = row[pad(p)];
        if (l0 == 1) {  // the pre-twiddle of z[m], which sits at m's bit reverse
          const int cls = class_at(classes, p, log_m), ls = log_m - cls;
          const int o = p & ~((1 << ls) - 1);
          v[t] = cmul(v[t], tw[pre_offset(n, cls) + bit_reverse(p - o, ls)]);
        }
      }
#pragma unroll
      for (int u = 0; u < kPassStages; ++u) {
        if (u >= np) break;
        const int l = l0 + u;
#pragma unroll
        for (int t = 0; t < (1 << kPassStages); ++t) {
          if (t >= (1 << np) || (t >> u) & 1) continue;
          // a position of a smaller subblock, which has no stage l
          if (classes != 0 && log_m - class_at(classes, base + t * h0, log_m) < l) continue;
          const int e = j + (t & ((1 << u) - 1)) * h0;
          const float2 b = cmul(v[t + (1 << u)], tw[e << (log_m - l)]);
          const float2 a = v[t];
          v[t] = make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
          v[t + (1 << u)] = make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
        }
      }
#pragma unroll
      for (int t = 0; t < (1 << kPassStages); ++t) {
        if (t >= (1 << np)) break;
        row[pad(base + t * h0)] = v[t];
      }
    }
    __syncthreads();
  }

  // post-twiddle, and the half-spectrum's order: complex positions o + j
  // and o + M-1-j of a subblock (one pair w = o/2 + j) become (v[2j],
  // v[2j + 1]) = (Re T[j], -Im T[M-1-j]) and (Re T[M-1-j], -Im T[j])
  for (int w = threadIdx.x; w < m_all / 2; w += kCta) {
    const int cls = class_at(classes, 2 * w, log_m), ms = m_all >> cls;
    const float2* post = tw + pre_offset(n, cls) + ms;
    if (ms == 1) {  // two subblocks of one point (N = 16, class 3)
      for (int p = 2 * w; p < 2 * w + 2; ++p) {
        const float2 t = cmul(row[pad(p)], post[0]);
        row[pad(p)] = make_float2(t.x, -t.y);
      }
      continue;
    }
    const int o = (2 * w) & ~(ms - 1), j = w - o / 2, jn = ms - 1 - j;
    const float2 tj = cmul(row[pad(o + j)], post[j]);
    const float2 tn = cmul(row[pad(o + jn)], post[jn]);
    row[pad(o + j)] = make_float2(tj.x, -tn.y);
    row[pad(o + jn)] = make_float2(tn.x, -tj.y);
  }
  __syncthreads();
}

// Plane index i of a row's half-spectra in shared memory.
__device__ __forceinline__ float plane_at(const float2* row, int i) {
  return reinterpret_cast<const float*>(row)[2 * pad(i >> 1) + (i & 1)];
}

}  // namespace ulcx_dct4
