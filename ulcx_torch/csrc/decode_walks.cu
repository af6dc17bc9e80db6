// Decode-pass walks of the ULC bitstream for Hopper (sm_90a).
//
// Three kernels, one per Pallas call of ulcx/bitstream/pallas_decode.py:
//   fsm_kernel<false>  <- _fsm_kernel (nybble-syntax state machine;
//                         pallas_call at :321): record and code planes
//   fsm_kernel<true>   <- the same machine fused with the record
//                         placement that ulcx keeps outside its kernel
//                         (fast_decode.py:88 _mm_place, a Mosaic kernel
//                         cannot scatter): expansion flags at record starts
//   rng_kernel<true>   <- _rng_expand_kernel (RNG replay fused with record
//                         fill and coefficient assembly; :497)
//   rng_kernel<false>  <- _rng_kernel (sign replay only; :380)
// Each computes what its Pallas kernel computes, not its block structure:
// the TPU grid's chunk loop, the VMEM scratch carry and the where-chains
// that stand in for table lookups have no counterpart. The FSM keeps
// mode, position, quantizer and run register in separate registers (the
// TPU packed them into one word), counts the tokens it reads itself, and
// stops at the end of the block: the wrapper zeroes the output planes,
// so tokens after the end read as "no record".
//
// Layouts (the wrappers in bitstream/decode_kernels.py check them):
//   token planes     [T, B]  stream fastest (tokens, rec, code)
//   position planes  [P, B]  stream fastest (flags, coef, sign)
//   per stream       [B]     (wc, seeds, consumed, corrupt)
//   next-end table   [16][8] int, the in-channel end of the segment that
//                            holds each N/8 slot, per window pattern
//   syntax table     [16][16] u32, one packed word per (mode, nybble)
// RNG seeds are u32, passed as int32 planes with the same bits.
//
// Bound: bytes (each input read once, each output written once) at the
// flagship shape B = 512, P = 4096, over 3.35 TB/s: FSM 10.2 MB -> 3.0
// us (1,662 tokens), its placing mode 11.8 MB -> 3.5 us; RNG-expand and
// RNG 16.8 MB -> 5.0 us each. Each is a serial recurrence over its
// stream with one walker per stream, so what sets its time is the
// latency of one step of the carried chain.
//
// All of them are ring-buffered walks (the machinery is in
// walk_ring.cuh): a CTA holds S streams (decode_kernels.fsm_geometry and
// rng_geometry give S, the chunk length L, the threads and the
// shared-memory bytes): lane j < S of warp 0 walks stream b0 + j, warps
// 1.. are helpers; the last CTA masks its missing streams. The helpers
// fill a 2-stage ring of L-row chunks with 4-byte cp.async copies (so
// any B is served) and do every device-memory store; one __syncthreads
// a chunk separates the pipeline's phases.
//
// fsm_kernel: the first design (one thread per stream, 32 a block, each
// token loaded from device memory inside the chain, a 16-way switch on
// the mode that the 32 streams of a warp serialised, the segment end
// recomputed every token) ran at 0.84 ms. This design:
//   - the helpers stage chunk k + 1 of the token plane while the walker
//     steps through chunk k and the helpers store what it left of chunk
//     k - 1; the walker reads its token a step ahead from shared memory;
//   - the switch became one packed word per (mode, nybble), 256 words in
//     shared memory that decode_kernels._syntax_words packs from the
//     plain version's syntax tables: next mode (CORRUPT for a bad
//     token), record kind, quantizer, run-register load, and the token's
//     share of the run length and the level, so no pre-pass is needed
//     and the step is one table read and selects on its fields, the same
//     instructions for every mode (ended lanes idle on the table's DONE
//     and CORRUPT rows);
//   - the segment end lives in a register and is looked up again only
//     when a record ends its segment;
//   - the walker assembles no output: per token it leaves the record
//     word and its registers (run register, quantizer, token, the
//     table's level field) in a shared stage, and the helpers build the
//     code word from them and store the planes' rows or, placing,
//     scatter each expansion word to flags[pos, b] (starts strictly
//     increase within a stream, so no two stores meet). A walker that
//     stored its own expansion words read 23 % slower;
//   - the barrier that ends a chunk votes (__syncthreads_and): once every
//     lane's block has ended or gone corrupt, the CTA stores the last
//     stage and stops loading (at CBR-128 a block ends near token 1,486
//     of 1,662).
// What remains in the chain is the table read (mode -> word), one
// multiply-add and a compare for the run length, and the selects.
//
// rng_kernel: the first design (one thread per stream, 32 a block, the
// flags loaded from device memory and the level and decay floats rebuilt
// from the codes inside the chain) ran at 1.27 ms (expand) and 0.26 ms
// (sign replay). This design takes both out of the chain:
//   - the helpers run a carry-free pre-pass over each staged chunk of
//     flags, data-parallel over (position, stream): the start, draw and
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

constexpr float kFltMin = 0x1p-126f;  // smallest normal f32
constexpr int kSyntaxWords = 16 * 16;
constexpr int kNextEnds = 16 * 8;
// A record word holds its start in 23 bits: P = n_chan * block_size <=
// 255 * 32768 < 2^23.
constexpr int kStartBits = 23;
constexpr int kStartMask = (1 << kStartBits) - 1;

// Shared memory of one FSM CTA: the syntax and next-end tables, then
// kStages stages of a chunk's tokens and the walker's two words per
// token. Mirrored by decode_kernels.fsm_smem_bytes.
struct FsmLayout {
  int tab, next_end, ring, tok, rec, regs, stage, total;
};
__host__ __device__ inline FsmLayout fsm_layout(int L, int S) {
  FsmLayout l{};
  l.tab = 0;
  l.next_end = l.tab + arr(kSyntaxWords);
  l.ring = l.next_end + arr(kNextEnds);
  l.tok = 0;
  l.rec = l.tok + arr(L * S);
  l.regs = l.rec + arr(L * S);
  l.stage = l.regs + arr(L * S);
  l.total = l.ring + kStages * l.stage;
  return l;
}

// Syntax word of (mode, nybble), as decode_kernels._syntax_words packs
// it: next mode 0-3 | record kind 4-6 | qi + 1 (0 keeps) 8-12 |
// run-register load 13-14 (1 = x, 2 = r0 << 4 | x) | run 15 | run
// length = field 16-21 + r0 * field 22-26 | level a = field 27-30 (a
// tail adds r0 >> 4).
constexpr uint32_t kLevelField = 0xFu << 27;

// Nybble-syntax state machine for one block of each stream. A record ends
// at the segment end (a quantizer stop, a tail), one past the
// coefficient, or after the run; the block ends when a record reaches P,
// and a segment's next token is a quantizer. Per stream it writes the
// tokens consumed (including the one that ends the block) and whether
// the block is corrupt (a run past its segment, a bad quantizer token,
// or no end within the T tokens). Where a token ends a record,
//   !kPlace: out0 = rec[t, b] = start | kind << 23 and out1 = code[t, b]
//            = a | dn << 5 | qi << 13, rows of the helpers' stores (0
//            where no record ends);
//   kPlace:  out0 = flags[start, b] = 1 | draw << 1 | coded << 2 |
//            tail << 3 | code << 4, scattered by the helpers; out1 is
//            not used.
// The walker stages, per token, the record word and its registers: r0 |
// qi << 8 | x << 16 | the syntax word's level field.
template <bool kPlace>
__global__ void __launch_bounds__(kMaxThreads)
    fsm_kernel(const int* __restrict__ wc, const int* __restrict__ tokens,
               const int* __restrict__ next_end, const uint32_t* __restrict__ syntax,
               int* __restrict__ out0, int* __restrict__ out1, int* __restrict__ consumed_out,
               int* __restrict__ corrupt_out, int B, int T, int P, int N, int S, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FsmLayout ly = fsm_layout(L, S);
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem + ly.tab);
  int* s_next_end = reinterpret_cast<int*>(smem + ly.next_end);
  const int b0 = blockIdx.x * S, ns = min(S, B - b0);
  const int nchunks = (T + L - 1) / L;
  const int tid = threadIdx.x, nh = blockDim.x - kWarp, h = tid - kWarp;
  auto arr_at = [&](int k, int off) {
    return reinterpret_cast<int*>(smem + ly.ring + (k & 1) * ly.stage + off);
  };

  for (int i = tid; i < kSyntaxWords; i += blockDim.x) s_tab[i] = syntax[i];
  for (int i = tid; i < kNextEnds; i += blockDim.x) s_next_end[i] = next_end[i];
  if (tid >= kWarp) {
    copy_rows(arr_at(0, ly.tok), S, tokens, 0, min(L, T), B, b0, ns, h, nh);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  const bool active = tid < ns;  // a walker lane of warp 0
  const int b = b0 + tid;
  const int* seg_row = s_next_end + (active ? ((wc[b] >> 4) & 15) * 8 : 0);
  const int slot_shift = __ffs(N >> 3) - 1;  // log2(N / 8)
  int mode = kQuantStart, pos = 0, qi = 0, r0 = 0, t = 0, se = seg_row[0];
  int n_walk = nchunks;  // chunks to walk: fewer once every lane has ended
  for (int k = 0; k <= n_walk; ++k) {
    if (tid < kWarp) {
      if (active && k < n_walk) {  // walk chunk k
        const Span s = chunk_span(k, L, T, false);
        const int n = s.hi - s.lo;
        const int* tok = arr_at(k, ly.tok);
        int* rec_s = arr_at(k, ly.rec);
        int* regs_s = arr_at(k, ly.regs);
        // branch-free but for the segment's end: the lanes are different
        // streams in different modes. The next token is read a step
        // ahead (past the chunk's last step the next array's word, unused).
        int idx = tid;
        int xn = tok[idx] & 15;
#pragma unroll 4
        for (int i = 0; i < n; ++i, idx += S) {
          const int x = xn;
          xn = tok[idx + S] & 15;
          const uint32_t w = s_tab[mode * 16 + x];
          t += mode < kDone;
          const int kind = (w >> 4) & 7u;  // unless the run overflows
          const int n_run =
              static_cast<int>((w >> 16) & 63u) + r0 * static_cast<int>((w >> 22) & 31u);
          const int end = (w >> 15) & 1u ? pos + n_run : kind == kRecCoef ? pos + 1 : se;
          const bool run_bad = end > se;  // only a run can pass its segment
          const bool emit = kind != kRecNone && !run_bad;
          rec_s[idx] = emit ? pos | (kind << kStartBits) : 0;
          regs_s[idx] = static_cast<int>(w & kLevelField) | (x << 16) | (qi << 8) | r0;
          int next = kind != kRecNone ? (end >= P ? kDone : end == se ? kQuantStart : kNormal)
                                      : static_cast<int>(w & 15u);
          next = run_bad ? kCorrupt : next;
          const int load = (w >> 13) & 3u;
          r0 = load == 1 ? x : load == 2 ? ((r0 << 4) | x) & 0xFF : r0;
          const int q = (w >> 8) & 31u;
          qi = q ? q - 1 : qi;
          pos = emit ? end : pos;
          if (emit && end == se)  // the next segment's end; rare, so the branch stays
            se = (pos & ~(N - 1)) + seg_row[(pos & (N - 1)) >> slot_shift];
          mode = next;
        }
      }
    } else {
      if (k + 1 < n_walk) {
        const Span s = chunk_span(k + 1, L, T, false);
        copy_rows(arr_at(k + 1, ly.tok), S, tokens, s.lo, s.hi - s.lo, B, b0, ns, h, nh);
      }
      __pipeline_commit();
      if (k >= 1) {  // build and store what the walker left of chunk k - 1
        const Span s = chunk_span(k - 1, L, T, false);
        const int* rec_s = arr_at(k - 1, ly.rec);
        const int* regs_s = arr_at(k - 1, ly.regs);
        for (int e = h; e < (s.hi - s.lo) * ns; e += nh) {
          const int i = e / ns, j = e - i * ns;
          const int rec = rec_s[i * S + j], regs = regs_s[i * S + j];
          const int kind = rec >> kStartBits;
          int code = 0;
          if (kind != kRecNone) {
            const int r0 = regs & 0xFF, x = (regs >> 16) & 15;
            const bool tail = kind == kRecTail;
            const int a = ((regs >> 27) & 15) + (tail ? r0 >> 4 : 0);
            const int dn = tail ? ((r0 & 0xF) << 4) | x : 0;
            code = a | (dn << 5) | (((regs >> 8) & 31) << 13);
          }
          if (kPlace) {
            // start | draw (noise, tail) | coded | tail, by record kind
            if (kind != kRecNone)
              out0[static_cast<size_t>(rec & kStartMask) * B + b0 + j] =
                  static_cast<int>((0xB3150u >> (kind * 4)) & 0xFu) | (code << 4);
          } else {
            const size_t g = static_cast<size_t>(s.lo + i) * B + b0 + j;
            out0[g] = rec;
            out1[g] = code;
          }
        }
      }
      __pipeline_wait_prior(0);  // this thread's copies of chunk k + 1 landed
    }
    // ends the chunk, and stops the walk once every lane has ended
    if (__syncthreads_and(!active || mode >= kDone)) n_walk = min(n_walk, k + 1);
  }
  if (active) {
    consumed_out[b] = t;
    corrupt_out[b] = mode != kDone;
  }
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

// Checks the FSM geometry the wrapper passes (decode_kernels.fsm_geometry)
// against this file's layout and launches; returns a cudaError_t.
template <bool kPlace>
int launch_fsm(const void* wc, const void* tokens, const void* next_end, const void* syntax,
               void* out0, void* out1, void* consumed, void* corrupt, int B, int T, int P, int N,
               int S, int L, int threads, int smem, void* stream) {
  if (S < 1 || S > kWarp || N < 8 || (N & (N - 1)) || P < 1 || P > kStartMask)
    return static_cast<int>(cudaErrorInvalidValue);
  static int allowed[kMaxDevices];
  const int rc = prepare_walk(fsm_kernel<kPlace>, allowed, L, threads, smem,
                              fsm_layout(L, S).total);
  if (rc) return rc;
  fsm_kernel<kPlace><<<(B + S - 1) / S, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(wc), static_cast<const int*>(tokens),
      static_cast<const int*>(next_end), static_cast<const uint32_t*>(syntax),
      static_cast<int*>(out0), static_cast<int*>(out1), static_cast<int*>(consumed),
      static_cast<int*>(corrupt), B, T, P, N, S, L);
  return static_cast<int>(cudaGetLastError());
}

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
// geometry check's, the shared-memory attribute's, or
// cudaGetLastError() after the launch.
extern "C" {

int ulcx_fsm(const void* wc, const void* tokens, const void* next_end, const void* syntax,
             void* rec, void* code, void* consumed, void* corrupt, int B, int T, int P, int N,
             int S, int L, int threads, int smem, void* stream) {
  return launch_fsm<false>(wc, tokens, next_end, syntax, rec, code, consumed, corrupt, B, T, P, N,
                           S, L, threads, smem, stream);
}

int ulcx_fsm_place(const void* wc, const void* tokens, const void* next_end, const void* syntax,
                   void* flags, void* consumed, void* corrupt, int B, int T, int P, int N,
                   int S, int L, int threads, int smem, void* stream) {
  return launch_fsm<true>(wc, tokens, next_end, syntax, flags, nullptr, consumed, corrupt, B, T, P,
                          N, S, L, threads, smem, stream);
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
