// Decode-pass walks of the ULC bitstream for Hopper (sm_90a).
//
// Three kernels, one per Pallas call of ulcx/bitstream/pallas_decode.py:
//   fsm_kernel         <- _fsm_kernel (nybble-syntax state machine;
//                         pallas_call at :321)
//   rng_kernel<true>   <- _rng_expand_kernel (RNG replay fused with record
//                         fill and coefficient assembly; :497)
//   rng_kernel<false>  <- _rng_kernel (sign replay only; :380)
// Each computes what its Pallas kernel computes, not its block structure:
// one thread per stream walks all tokens (FSM) or all P positions (RNG)
// serially, so the TPU grid's chunk loop, the VMEM scratch carry and the
// where-chains that stand in for table lookups have no counterpart. The
// FSM keeps mode, position, quantizer and run register in separate
// registers (the TPU packed them into one word), counts the tokens it
// reads itself, and stops at the end of the block: the wrapper zeroes
// the record planes, so tokens after the end read as "no record".
//
// Layouts (the wrappers in bitstream/decode_kernels.py check them):
//   token planes     [T, B]  stream fastest (tokens, rec, code)
//   position planes  [P, B]  stream fastest (flags, coef, sign)
//   per stream       [B]     (wc, seeds, consumed, corrupt)
//   next-end table   [16][8] int, the in-channel end of the segment that
//                            holds each N/8 slot, per window pattern
// RNG seeds are u32, passed as int32 planes with the same bits.
//
// Bound: each kernel is a serial, latency-bound recurrence with one
// thread per stream. At B = 512 that is 512 threads, 16 warps, fewer than
// the encode walks' 4096 and far below the card's 270,336 resident-thread
// slots (132 SMs x 2048): each warp steps through ~1,660 tokens (FSM at
// the flagship's window) or 4,096 positions (RNG) of dependent
// iterations, one global load each. Nothing is done about that yet.
//
// Numerics: built without --use_fast_math. The level and decay floats
// are exact products; the tail decay mag *= dcy is one rounded product
// per step (__fmul_rn, so nvcc cannot contract it), and a magnitude that
// leaves the normal range is flushed to zero, as the TPU and XLA flush
// denormals.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode {
  kQuantStart = 0, kQuantExtS, kNormal, kQuantMid, kQuantExtM, kZShort, kLRunY, kLRunX,
  kNoiseZ, kNoiseY, kNoiseX, kTailZ, kTailY, kTailX, kDone, kCorrupt
};
enum Rec { kRecNone = 0, kRecCoef, kRecZero, kRecNoise, kRecTail };

constexpr int kThreads = 32;  // one warp per block: B = 512 gives 16 blocks
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
// a << 4 | dn << 9 | qi << 17); the draw bit, level and decay latch at
// record starts and the kernel writes each coefficient. Otherwise flags
// are draw bit 0 | start bit 1 and it writes the sign (+-1). Both write
// the final xorshift32 state.
template <bool kExpand>
__global__ void rng_kernel(const int* __restrict__ flags, const uint32_t* __restrict__ seed,
                           float* __restrict__ out, uint32_t* __restrict__ seed_out, int B,
                           int P) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t state = seed[b], parity = 0;
  bool draw = false;
  float lvl = 0.0f, mag = 0.0f, dcy = 0.0f;
  for (int p = 0; p < P; ++p) {
    const size_t pb = static_cast<size_t>(p) * B + b;
    const int f = flags[pb];
    const bool start = kExpand ? (f & 1) : (f & 2);
    bool is_coef = false;
    if (kExpand) {
      if (start) {
        draw = (f >> 1) & 1;
        const int a = (f >> 4) & 0x1F;
        const int dn = (f >> 9) & 0xFF;
        const float quant = expand_quant((f >> 17) & 0x1F);
        const int s = ((a & 0xF) ^ 0x8) - 0x8;
        if (f & 4) {
          lvl = __fmul_rn(static_cast<float>(s < 0 ? -(s * s) : s * s), quant);
        } else {
          const float aa = __fmul_rn(static_cast<float>(a * a), quant);
          lvl = __fmul_rn(aa, (f & 8) ? 0.0625f : 0.25f);
        }
        dcy = (f & 8) ? __fadd_rn(1.0f, __fmul_rn(static_cast<float>(dn * dn), -0x1p-19f)) : 0.0f;
        mag = lvl;
      }
      is_coef = f & 4;
    } else {
      draw = f & 1;
    }
    if (draw) state = xorshift32(state);
    if (start) parity = 0;
    if (draw) parity ^= state >> 31;
    if (kExpand) {
      out[pb] = is_coef ? lvl : draw ? (parity ? -mag : mag) : 0.0f;
      if (draw && dcy != 0.0f) {
        mag = __fmul_rn(mag, dcy);
        if (fabsf(mag) < kFltMin) mag = __fmul_rn(mag, 0.0f);
      }
    } else {
      out[pb] = parity ? -1.0f : 1.0f;
    }
  }
  seed_out[b] = state;
}

inline int grid_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, allocates nothing, and returns cudaGetLastError() as an int.
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
                    void* stream) {
  rng_kernel<true><<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flags), static_cast<const uint32_t*>(seed),
      static_cast<float*>(coef), static_cast<uint32_t*>(seed_out), B, P);
  return static_cast<int>(cudaGetLastError());
}

int ulcx_rng(const void* flags, const void* seed, void* sign, void* seed_out, int B, int P,
             void* stream) {
  rng_kernel<false><<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flags), static_cast<const uint32_t*>(seed),
      static_cast<float*>(sign), static_cast<uint32_t*>(seed_out), B, P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
