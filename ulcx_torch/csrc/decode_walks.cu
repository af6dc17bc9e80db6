// Decode-pass walks of the ULC bitstream for Hopper (sm_90a).
//
// Three kernels, one per Pallas call of ulcx/bitstream/pallas_decode.py:
//   fsm_kernel         <- _fsm_kernel (nybble-syntax state machine;
//                         pallas_call at :321)
//   rng_kernel<true>   <- _rng_expand_kernel (RNG replay fused with record
//                         fill and coefficient assembly; :497)
//   rng_kernel<false>  <- _rng_kernel (sign replay only; :380)
// Each computes what its Pallas kernel computes, not its block structure:
// the TPU grid's chunk loop, the VMEM scratch carry and the where-chains
// that stand in for table lookups have no counterpart. The FSM keeps
// mode, position, quantizer and run register in separate registers (the
// TPU packed them into one word), counts the tokens it reads itself, and
// stops at the end of the block: the wrapper zeroes the record planes,
// so tokens after the end read as "no record".
//
// Layouts (the wrappers in bitstream/decode_kernels.py check them):
//   token planes     [T, B]  stream fastest (tokens, rec, code)
//   position planes  [P, B]  stream fastest (flags, coef, sign)
//   per stream       [B]     (wc, seeds, consumed, corrupt)
//   next-end table   [16][8] int, the in-channel end of the segment that
//                            holds each N/8 slot, per window pattern
// RNG seeds are u32, passed as int32 planes with the same bits.
//
// Bound: bytes (each input read once, each output written once) at the
// flagship shape B = 512, P = 4096, over 3.35 TB/s: FSM 10.2 MB -> 3.0
// us (1,662 tokens); RNG-expand and RNG 16.8 MB -> 5.0 us each. Each is
// a serial recurrence over its stream with one walker per stream, so
// what sets its time is the latency of one step of the carried chain.
//
// fsm_kernel: one thread per stream walks all tokens and loads each
// token from device memory inside the chain (0.84 ms at the flagship
// shape); it is the next in the redesign queue.
//
// rng_kernel: the first design (one thread per stream, 32 a block, the
// flags loaded from device memory and the level and decay floats rebuilt
// from the codes inside the chain) ran at 1.27 ms (expand) and 0.26 ms
// (sign replay). This design takes both out of the chain (the ring
// machinery is in walk_ring.cuh):
//   - a CTA holds S streams (decode_kernels.rng_geometry gives S, the
//     chunk length L, the threads and the shared-memory bytes): lane j <
//     S of warp 0 walks stream b0 + j, warps 1.. are helpers; the last
//     CTA masks its missing streams;
//   - the helpers fill a 2-stage ring of L-position chunks of flags with
//     4-byte cp.async copies, then run a carry-free pre-pass over each
//     chunk, data-parallel over (position, stream): the start, draw and
//     coded-coefficient bits into one word and, at record starts, the
//     level and decay floats of expand_quant, a, dn and qi;
//   - the walker keeps only the carry (the draw latch, the xorshift32
//     state, the parity, the magnitude and its decay), reads three
//     shared words a step, and writes each coefficient (or sign) to a
//     shared stage that the helpers store as [P, B] rows;
//   - one __syncthreads a chunk separates load (chunk k+1), pre-pass
//     (k), walk (k-1) and store (k-2).
// What remains in the chain is the xorshift (six dependent integer
// operations), the parity and one rounded product.
//
// Numerics: built without --use_fast_math. The level and decay floats
// are exact products; the tail decay mag *= dcy is one rounded product
// per step (__fmul_rn, so nvcc cannot contract it), and a magnitude that
// leaves the normal range is flushed to zero, as the TPU and XLA flush
// denormals.

#include "walk_ring.cuh"

namespace {

enum Mode {
  kQuantStart = 0, kQuantExtS, kNormal, kQuantMid, kQuantExtM, kZShort, kLRunY, kLRunX,
  kNoiseZ, kNoiseY, kNoiseX, kTailZ, kTailY, kTailX, kDone, kCorrupt
};
enum Rec { kRecNone = 0, kRecCoef, kRecZero, kRecNoise, kRecTail };

constexpr int kThreads = 32;  // fsm: one warp per block, B = 512 gives 16 blocks
constexpr float kFltMin = 0x1p-126f;  // smallest normal f32

// Nybble-syntax state machine for one block of each stream. Per token it
// writes a record word (start | type << 15) and a code word
// (a | dn << 5 | qi << 13) where a record ends; per stream, the tokens
// consumed (including the one that ends the block) and whether the block
// is corrupt (a run past its segment, a bad quantizer token, or no end
// within the T tokens).
__global__ void fsm_kernel(const int* __restrict__ wc, const int* __restrict__ tokens,
                           const int* __restrict__ next_end, int* __restrict__ rec,
                           int* __restrict__ code, int* __restrict__ consumed_out,
                           int* __restrict__ corrupt_out, int B, int T, int P, int N) {
  __shared__ int s_next_end[16 * 8];
  for (int i = threadIdx.x; i < 16 * 8; i += blockDim.x) s_next_end[i] = next_end[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* seg_row = s_next_end + ((wc[b] >> 4) & 15) * 8;
  const int slot_shift = __ffs(N >> 3) - 1;  // log2(N / 8)
  int mode = kQuantStart, pos = 0, qi = 0, r0 = 0, t = 0;
  for (; t < T && mode < kDone; ++t) {
    const size_t tb = static_cast<size_t>(t) * B + b;
    const int x = tokens[tb];
    const int se = (pos & ~(N - 1)) + seg_row[(pos & (N - 1)) >> slot_shift];
    const int remaining = se - pos;
    int rtype = kRecNone, a = 0, dn = 0, end = pos;
    switch (mode) {
      case kQuantStart:
        if (x == 0xF) {
          mode = kCorrupt;
        } else if (x == 0xE) {
          mode = kQuantExtS;
        } else {
          qi = x;
          mode = kNormal;
        }
        break;
      case kQuantExtS:
      case kQuantExtM:
        if (x == 0xF) {
          rtype = kRecZero;
          end = se;
        } else {
          qi = 0xE + x;
          mode = kNormal;
        }
        break;
      case kQuantMid:
        if (x == 0xF) {
          mode = kTailZ;
        } else if (x == 0xE) {
          mode = kQuantExtM;
        } else {
          qi = x;
          mode = kNormal;
        }
        break;
      case kNormal:
        if (x == 0x0) {
          mode = kZShort;
        } else if (x == 0x1) {
          mode = kLRunY;
        } else if (x == 0x8) {
          mode = kNoiseZ;
        } else if (x == 0xF) {
          mode = kQuantMid;
        } else {
          rtype = kRecCoef;
          a = x;
          end = pos + 1;
        }
        break;
      case kZShort:
      case kLRunX:
      case kNoiseX: {
        const int n_run = mode == kZShort ? x + 1
                          : mode == kLRunX ? ((r0 << 4) | x) + 33
                                           : ((r0 << 1) | (x & 1)) + 16;
        if (n_run > remaining) {
          mode = kCorrupt;
        } else {
          rtype = mode == kNoiseX ? kRecNoise : kRecZero;
          a = mode == kNoiseX ? (x >> 1) + 1 : 0;
          end = pos + n_run;
        }
        break;
      }
      case kLRunY:
      case kNoiseZ:
      case kTailZ:
        r0 = x;
        mode += 1;
        break;
      case kNoiseY:
      case kTailY:
        r0 = ((r0 << 4) | x) & 0xFF;
        mode += 1;
        break;
      case kTailX:
        rtype = kRecTail;
        a = (r0 >> 4) + 1;
        dn = ((r0 & 0xF) << 4) | x;
        end = se;
        break;
    }
    if (rtype != kRecNone) {
      rec[tb] = min(pos, 0x7FFF) | (rtype << 15);
      code[tb] = a | (dn << 5) | (qi << 13);
      pos = end;
      mode = end >= P ? kDone : end == se ? kQuantStart : kNormal;
    }
  }
  consumed_out[b] = t;
  corrupt_out[b] = mode != kDone;
}

__device__ __forceinline__ uint32_t xorshift32(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

// ((1 << 26) >> qi) * 2^-31, 0 for qi > 26 (reference ulcDecoder.c:96-98)
__device__ __forceinline__ float expand_quant(int qi) {
  return qi < 27 ? __fmul_rn(static_cast<float>((1 << 26) >> qi), 0x1p-31f) : 0.0f;
}

// Noise-RNG replay over P positions. kExpand: flags are the expansion
// flags (start bit 0 | draw record 1 | coded coefficient 2 | tail 3 |
// a << 4 | dn << 9 | qi << 17); the draw bit, magnitude and decay latch
// at record starts and the kernel writes each coefficient. Otherwise
// flags are draw bit 0 | start bit 1 and it writes the sign (+-1). Both
// write the final xorshift32 state.
//
// Pre-pass word: start bit 0 | draw bit 1 | coded coefficient 2 | (with
// kExpand) the record decays, draw and decay != 0, 3; with kExpand, per
// position the level (the coefficient's value, or the run's starting
// magnitude) and the decay, all read at starts only.
struct RngLayout {
  int flags, pp, lvl, dcy, out, stage, total;
};
__host__ __device__ inline RngLayout rng_layout(int L, int S, bool expand) {
  RngLayout l{};
  l.flags = 0;
  l.pp = l.flags + arr(L * S);
  l.lvl = l.pp + arr(L * S);
  l.dcy = l.lvl + (expand ? arr(L * S) : 0);
  l.out = l.dcy + (expand ? arr(L * S) : 0);
  l.stage = l.out + arr(L * S);
  l.total = kStages * l.stage;
  return l;
}

template <bool kExpand>
__global__ void __launch_bounds__(kMaxThreads)
    rng_kernel(const int* __restrict__ flags, const uint32_t* __restrict__ seed,
               float* __restrict__ out, uint32_t* __restrict__ seed_out, int B, int P, int S,
               int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RngLayout ly = rng_layout(L, S, kExpand);
  const int b0 = blockIdx.x * S, ns = min(S, B - b0);
  const int nchunks = (P + L - 1) / L;
  const int tid = threadIdx.x, nh = blockDim.x - kWarp, h = tid - kWarp;
  auto arr_at = [&](int k, int off) { return reinterpret_cast<int*>(smem + (k & 1) * ly.stage + off); };

  if (tid >= kWarp) {
    copy_rows(arr_at(0, ly.flags), S, flags, 0, min(L, P), B, b0, ns, h, nh);
    __pipeline_commit();
  }
  __syncthreads();

  const bool active = tid < ns;  // a walker lane of warp 0
  uint32_t state = active ? seed[b0 + tid] : 0u, parity = 0;
  bool draw = false, decays = false;
  float lvl = 0.0f, mag = 0.0f, dcy = 0.0f;
  for (int k = 0; k <= nchunks + 1; ++k) {
    if (tid < kWarp) {
      if (active && k >= 1 && k <= nchunks) {  // walk chunk k - 1
        const Span s = chunk_span(k - 1, L, P, false);
        const int n = s.hi - s.lo;
        const uint32_t* pp = reinterpret_cast<const uint32_t*>(arr_at(k - 1, ly.pp));
        const float* lvl_s = reinterpret_cast<const float*>(arr_at(k - 1, ly.lvl));
        const float* dcy_s = reinterpret_cast<const float*>(arr_at(k - 1, ly.dcy));
        float* o = reinterpret_cast<float*>(arr_at(k - 1, ly.out));
        // branch-free, with the next step's words loaded ahead (past the
        // chunk's last step that reads the next array's words, unused):
        // the lanes are different streams and diverge at every record
        // start
        int x = tid;
        uint32_t wn = pp[x];
        float lvn = kExpand ? lvl_s[x] : 0.0f, dvn = kExpand ? dcy_s[x] : 0.0f;
#pragma unroll 4
        for (int i = 0; i < n; ++i, x += S) {
          const uint32_t w = wn;
          const float lv = lvn, dv = dvn;
          wn = pp[x + S];
          if (kExpand) {
            lvn = lvl_s[x + S];
            dvn = dcy_s[x + S];
          }
          const bool start = w & 1u;
          if (kExpand) {
            draw = start ? (w & 2u) != 0 : draw;
            decays = start ? (w & 8u) != 0 : decays;
            lvl = start ? lv : lvl;
            mag = start ? lv : mag;
            dcy = start ? dv : dcy;
          } else {
            draw = w & 2u;
          }
          const uint32_t xs = xorshift32(state);
          state = draw ? xs : state;
          parity = (start ? 0u : parity) ^ (draw ? xs >> 31 : 0u);
          if (kExpand) {
            o[x] = (w & 4u) ? lvl : draw ? (parity ? -mag : mag) : 0.0f;
            float m = __fmul_rn(mag, dcy);
            m = fabsf(m) < kFltMin ? __fmul_rn(m, 0.0f) : m;
            mag = decays ? m : mag;
          } else {
            o[x] = parity ? -1.0f : 1.0f;
          }
        }
      }
    } else {
      if (k + 1 < nchunks) {
        const Span s = chunk_span(k + 1, L, P, false);
        copy_rows(arr_at(k + 1, ly.flags), S, flags, s.lo, s.hi - s.lo, B, b0, ns, h, nh);
      }
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this thread's copies of chunk k landed
      helpers_sync(nh);          // and every helper's
      if (k < nchunks) {         // pre-pass of chunk k
        const Span s = chunk_span(k, L, P, false);
        const int* f_s = arr_at(k, ly.flags);
        uint32_t* pp = reinterpret_cast<uint32_t*>(arr_at(k, ly.pp));
        float* lvl_s = reinterpret_cast<float*>(arr_at(k, ly.lvl));
        float* dcy_s = reinterpret_cast<float*>(arr_at(k, ly.dcy));
        for (int e = h; e < (s.hi - s.lo) * S; e += nh) {
          const int i = e / S, j = e - i * S;
          if (j >= ns) continue;
          const int f = f_s[i * S + j];
          if (kExpand) {
            float lv = 0.0f, dc = 0.0f;
            if (f & 1) {
              const int a = (f >> 4) & 0x1F;
              const int dn = (f >> 9) & 0xFF;
              const float quant = expand_quant((f >> 17) & 0x1F);
              const int sa = ((a & 0xF) ^ 0x8) - 0x8;
              if (f & 4) {
                lv = __fmul_rn(static_cast<float>(sa < 0 ? -(sa * sa) : sa * sa), quant);
              } else {
                const float aa = __fmul_rn(static_cast<float>(a * a), quant);
                lv = __fmul_rn(aa, (f & 8) ? 0.0625f : 0.25f);
              }
              dc = (f & 8) ? __fadd_rn(1.0f, __fmul_rn(static_cast<float>(dn * dn), -0x1p-19f))
                           : 0.0f;
            }
            pp[e] = static_cast<uint32_t>(f & 7) |
                    (static_cast<uint32_t>((f & 2) && dc != 0.0f) << 3);
            lvl_s[e] = lv;
            dcy_s[e] = dc;
          } else {
            pp[e] = static_cast<uint32_t>(((f >> 1) & 1) | ((f & 1) << 1));
          }
        }
      }
      if (k >= 2) {  // store chunk k - 2's rows
        const Span s = chunk_span(k - 2, L, P, false);
        const float* o = reinterpret_cast<const float*>(arr_at(k - 2, ly.out));
        for (int e = h; e < (s.hi - s.lo) * ns; e += nh) {
          const int i = e / ns, j = e - i * ns;
          out[static_cast<size_t>(s.lo + i) * B + b0 + j] = o[i * S + j];
        }
      }
    }
    __syncthreads();
  }
  if (active) seed_out[b0 + tid] = state;
}

inline int grid_for(int B) { return (B + kThreads - 1) / kThreads; }

// Checks the RNG geometry the wrapper passes (decode_kernels.rng_geometry)
// against this file's layout and launches; returns a cudaError_t.
template <bool kExpand>
int launch_rng(const void* flags, const void* seed, void* out, void* seed_out, int B, int P,
               int S, int L, int threads, int smem, void* stream) {
  if (S < 1 || S > kWarp) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed[kMaxDevices];
  const int rc = prepare_walk(rng_kernel<kExpand>, allowed, L, threads, smem,
                              rng_layout(L, S, kExpand).total);
  if (rc) return rc;
  rng_kernel<kExpand><<<(B + S - 1) / S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flags), static_cast<const uint32_t*>(seed),
      static_cast<float*>(out), static_cast<uint32_t*>(seed_out), B, P, S, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, allocates nothing, and returns a cudaError_t as an int: the
// RNG geometry check's, the shared-memory attribute's, or
// cudaGetLastError() after the launch.
extern "C" {

int ulcx_fsm(const void* wc, const void* tokens, const void* next_end, void* rec, void* code,
             void* consumed, void* corrupt, int B, int T, int P, int N, void* stream) {
  fsm_kernel<<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wc), static_cast<const int*>(tokens),
      static_cast<const int*>(next_end), static_cast<int*>(rec), static_cast<int*>(code),
      static_cast<int*>(consumed), static_cast<int*>(corrupt), B, T, P, N);
  return static_cast<int>(cudaGetLastError());
}

int ulcx_rng_expand(const void* flags, const void* seed, void* coef, void* seed_out, int B, int P,
                    int S, int L, int threads, int smem, void* stream) {
  return launch_rng<true>(flags, seed, coef, seed_out, B, P, S, L, threads, smem, stream);
}

int ulcx_rng(const void* flags, const void* seed, void* sign, void* seed_out, int B, int P, int S,
             int L, int threads, int smem, void* stream) {
  return launch_rng<false>(flags, seed, sign, seed_out, B, P, S, L, threads, smem, stream);
}

}  // extern "C"
