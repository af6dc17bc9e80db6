#!/usr/bin/env python3
"""Drive the PyTorch port's encode and decode paths, tools and mesh on one CUDA card.

    python3 chip_smoke.py        # from the repo root; one CUDA GPU, nvcc on the machine

Phases, each of which raises on failure:

1. device: require CUDA, turn TF32 off, print the card's name and power limit;
2. build the four encode-walk and four decode kernels (the FSM in its
   record and its placing mode, RNG-expand, RNG) from
   ``ulcx_torch/csrc`` (one nvcc call), print each kernel's registers
   and spills as ptxas reports them, and check that every entry point
   that takes a launch geometry refuses one whose shared-memory bytes
   differ from its Python mirror's;
3. kernels vs plain: one block step's walk planes at the flagship shape
   (stereo bs2048, P=4096, from ``bench.make_corpus``), at the main
   path's B=512, go through each kernel and its plain PyTorch version on
   the card; every output must be identical, and both are
   timed; then every kernel again at a ragged shape (B=13 streams, not a
   multiple of the walks' stream tile, 3 channels x bs256, P=768),
   identical too, p3 materialize also into a 6-word buffer;
4. main path: ``batch_encode`` CBR-128 at B=512, T=8 on the card; every
   block within its budget, the launch counters exactly T x (3, 3, 2, 1),
   a second run byte-identical; prints the encode realtime factor;
5. CUDA vs CPU: B=8, T=2 through the same path on the CPU (the plain
   walks); window control and coded counts exact, total size within 1 %;
6. decode kernels vs plain: phase 4's bytes packed into streams as
   bench.py packs them, windows of the first and of a later block at the
   bench's window size, at B=512 and a ragged B=13 (not a
   multiple of the decode kernels' stream tile); each decode kernel's
   outputs identical to its plain version's (coefficients as bits), both
   timed, the flags that feed the RNG kernels being the placing FSM's;
   then both FSM modes at B=13 on windows the encoder never writes
   (random bytes and real windows with a random second half, which go
   corrupt mid-block; windows cut short, which exhaust their tokens; and
   windows coded coefficient by coefficient, 33 of the kernel's chunks
   long), all 16 window patterns among them; then RNG-expand and RNG on
   synthetic record flags (B=13, P=4096) whose first record is a steep
   tail that decays through the flush to zero over a dozen of the
   kernels' chunks;
7. decode main path: ``batch_decode`` of those streams at B=512, T=8 on
   the card; no corrupt block, every block's bits rounded up to bytes
   equal to its encoded size, the launch counters exactly T x (0, 1, 1,
   0) for (fsm, fsm_place, rng_expand, rng), a second run bit-identical;
   prints the decode realtime factor and the round-trip SNR;
8. decode CUDA vs CPU: the first 8 streams, 2 blocks, on the CPU port;
   bits and corrupt exact, PCM within 1e-5 RMS;
9. transforms on the card: the ``fact`` and ``fft`` backends of
   ``ops.dct`` against the dense ``matmul`` backend at N=4096 and 8192
   (``dct4``, ``dst4`` and the fused pair, random [64, N] input), each
   within 1e-5 of the block's largest magnitude; the three backends are
   timed at [1024, N];
10. large blocks, stereo bs4096 (P=8192, the N=4096 subblock on the
    ``fact`` backend): the four encode and the four decode kernels
    against their plain versions at the B=256 of the path that follows,
    then ``batch_encode`` CBR-128 and ``batch_decode`` of its bytes at
    B=256, T=4 with the checks of phases 4 and 7;
11. folded encode at phase 4's shape: ``fold_bitstream=8`` must give
    phase 4's bytes and sizes with the walks launched (3, 3, 2, 1) x
    T/8 times; ``flat_stream=True`` phase 4's window control with
    (3, 3, 2, 1) launches in all. Its transform products run at B*T rows,
    where the card's GEMM sums in another order than at B rows, so
    near-ties of the importance order fall otherwise
    (``devtools/torch_flat_nearties.py`` shows them) and bytes and sizes
    differ in part of the blocks: every block must stay within its
    budget and within 64 bits of phase 4's size, the coded counts of the
    two analyses may differ in at most 0.5 % of the blocks, the total
    size stays within 0.1 % of phase 4's, and the bytes must decode
    without a corrupt block to a round-trip SNR within 0.3 dB of phase
    7's; the blocks with identical sizes and bytes are counted. Prints
    each one's realtime factor and peak memory;
12. single stream: ``encode_stream`` of one stream's 64 blocks (stereo
    bs2048, CBR-128): bytes identical to two calls of 32 blocks with the
    carry passed on and to ``batch_encode`` of the stream as a batch of
    one with ``fold_bitstream=64`` (the plan follows the bitstream
    batch, 64 streams either way), the walks launched (3, 3, 2, 1) times
    in all; ``decode_stream``
    of the packed bytes in one call, launching T x (0, 1, 1, 0), and in
    two calls chained through ``(offset, carry)``: identical bits,
    corrupt flags and PCM, no corrupt block; the first 4 blocks through
    both entry points on the CPU (the plain walks at these batch sizes)
    with the tolerances of phases 5 and 8; prints both realtime factors;
    then ``decode_stream_pipelined`` of the stream: bits, corrupt flags,
    offset and RNG state identical to ``decode_stream``'s, PCM within
    1e-5 relative and the lap within 1e-5, 64 placing-FSM launches and
    one RNG-expand launch; prints its realtime factor beside
    ``decode_stream``'s;
13. past P = 32768, stereo bs32768 (P = 65,536, the reference's largest
    block in stereo): all eight kernels against their plain versions at
    a ragged B=13, the plain versions on the CPU on copies of the same
    planes (on the card they would launch hundreds of thousands of small
    kernels), every kernel timed at B=256, then ``batch_encode`` CBR-128
    (above P = 32768 only the scan path's plan, ulcx's exact 16-candidate
    ladder: launches T x (9, 9, 8, 1)) and
    ``batch_decode`` of its bytes at B=256, T=2 with the checks of
    phases 4 and 7; prints both realtime factors and the peak memory;
14. rate paths at stereo bs256, B=13, T=2 (no multiple of 8: the scan
    path's plan): ``rate_search="bisect"`` on
    the kernels (launches T x (11, 11, 10, 1)), its count, size and
    bytes from the same walk inputs identical on the card and the CPU,
    end to end within 1 % of the CPU's; ``use_pallas="off"`` on the
    card, with the ladder and with bisect: no kernel launched, bytes
    (and, decoding, PCM, bits and corrupt flags) identical to the
    kernels'; the ladder and bisect encodes timed;
15. gap window: ``noise_run_window="gap"`` at phase 4's shape (B=512,
    T=8, CBR-128): launches exactly T x (7, 7, 0, 0) (the scan path's
    ladder; both p3 walks run their plain gap mode on the card), every block
    within its budget, a second run identical, the streams decoded with
    phase 7's checks; prints the gap and segment encode realtime factors
    and total sizes of this process; times the gap p3 walks on a block
    step's planes beside the segment window's plain walks and kernels,
    and holds them on 8 of its streams to the same walks on the CPU in
    every (stream, candidate) whose noise codes the two devices' ``exp``
    agree on;
16. tools: four 30 s stereo PCM16 WAVs of ``bench.make_corpus``;
    ``python -m ulcx_torch.tools.encode_tool`` by subprocess at CBR-128,
    VBR -55 and ABR 128,0.5 (exit 0, the stats lines, the header fields,
    the CBR budget), ``decode_tool`` of the CBR file to PCM16 and
    FLOAT32 (FLOAT32 within 1e-5 relative of ``decode_stream`` of the
    same bytes, PCM16 within one LSB of it converted, SNR over the
    middle blocks against the input one block earlier above 12 dB), the
    verify SKILL's five error paths with their messages and exit codes
    (1, 1, 255, 255, 255); each tool again in process, timed (encode
    bytes identical to the subprocess's); ``batch_tool`` over the four
    files, which it pads with zero streams to a batch of 8, the kernel
    path's plan: launches exactly (3, 3, 2, 1) x the block steps it coded,
    headers, budgets, clean decodes; its aggregate realtime factor
    printed beside the figure it had on the scan path's plan, before it
    padded; ``-profile:DIR`` writes a
    trace; a checkpoint on the card (half the blocks, ``save_carry``,
    ``load_carry``, the rest) gives one call's bytes. Prints whether the
    native I/O library loaded and each tool's realtime factor;
17. mesh: (a) ``data_mesh()`` in this process, a world of one over NCCL,
    through phases 4 and 7 with their checks: blocks, sizes, PCM, bits
    and corrupt flags identical to theirs, the total the float32 sum,
    launches T x (3, 3, 2, 1) and T x (0, 1, 1, 0); (b) ``python -m
    ulcx_torch.graft_entry mesh`` under torchrun at phase 4's shape:
    NCCL over a card each where two or more are visible (at most four),
    else two ranks sharing card 0 over gloo. Each rank's launches are
    phase 4's and 7's, its shard equals the no-mesh call on its rows,
    its refusals raise, its blocks decode clean; the whole holds phase
    11's card bounds against phase 4 (window control identical, each
    block within 64 bits, the total within 0.1 %, coded counts differing
    in at most 0.5 % of blocks, SNR within 0.3 dB of phase 7's); the
    all-reduced total is the float32 sum of the shards. Prints the
    aggregate encode and decode realtime factors (the median of 3 runs,
    each from a barrier before the call to one after it on every rank)
    beside phase 4's and 7's, and how many cards took part; (c)
    ``dryrun_multichip`` over as many ranks, and ``entry()``'s block
    step once on the card;
18. scan path: 16 channels x bs2048 CBR-128 (P = 32768) at B=13, T=2,
    a batch ulcx codes on its scan path's plan: launches exactly T x
    (9, 9, 8, 1), every block within its budget, a second run identical,
    count, size and bytes from the same walk inputs identical on the
    card and the CPU, a clean decode; the first 8 streams again on the
    kernel path's plan (B=8: T x (3, 3, 2, 1)), the two totals, the
    share of blocks the scan plan codes larger, and both round-trip
    SNRs (the scan plan's at most 0.3 dB below). Then ``encode_block``
    over 12 flagship blocks, launching (7, 7, 6, 1) a block, identical
    to ``encode_stream`` of them (T=12, the scan path's plan too), and
    ``decode_block`` of their bytes, identical to ``decode_stream``
    (PCM, bits, corrupt flags, carry) with the record-mode FSM kernel
    and RNG-expand launched once a block;
19. public names: ``rate_search_fast`` on the flagship's first block step
    (B=512, P=4096): launches exactly (3, 3, 3, 0), the count equal to
    ``search_materialize_fast``'s and to its own with ``use_pallas="off"``
    (the plain walks on the card), again at a ragged B=13; both searches
    timed (median of warm calls); ``mdct_mdst_frame`` and ``mdct_frame``
    (S=2048 ``matmul``, S=32768 ``fact`` and ``fft``, an overlap pair a
    row) and ``ema`` on [512, 4096] in both directions against the same
    calls on the CPU, within 1e-5 and 3e-5 of the largest magnitude;
20. inverse transform kernel: ``transform_batched.imdct`` (the fast
    DCT-IV of each row's active subblocks with their windows and lap,
    ``csrc/imdct.cu``) against its plain version on the card (the four
    class GEMMs and ``imdct_lap_plain``) at the decode cell's shape
    (B=8192, C=2, N=2048) and at P = 65,536 (B=256, N=32768), on every
    (pattern, scale, prev_last_ss) and on long blocks only: PCM and lap
    within 1e-5 of each row's peak, last_ss exact, one launch a call;
    both timed, the kernel beside its byte bound (12 N bytes a row: the
    coefficients and the lap read, the PCM and the new lap written).
    Phase 7 also holds its launches to one a block.

Each phase prints the seconds it took.

The second-to-last line is a JSON object with each kernel's launches on
its main path (the record-mode FSM's: ``decode_block``, phase 18), its
largest difference from the plain version, both
times at the main path's B=512, and its bound: the bytes of its inputs
and outputs at that shape over the card's 3.35 TB/s (no PyTorch call
computes any of these serial walks, so ``library_ms`` is null); beside
them the times at P = 8192 (phase 10) and P = 65,536 (phase 13) and the
launches on the other paths (the gap window's, the mesh's, the batch
tool's and ``rate_search_fast``'s among them); the last is
``{"ok": true, "device": {...}}``. The script exits non-zero, printing
neither, when there is no CUDA device or any phase fails. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BS = 2048
RATE_KBPS = 128.0
CBR_BUDGET = 5944  # bits per block: CBR 128 kbps at bs2048, 44.1 kHz
MAIN_B, MAIN_T = 512, 8
CPU_B, CPU_T = 8, 2
WARMUP_LAUNCHES, TIMED_LAUNCHES = 10, 50  # warm-up lets the clocks ramp after the plain run
HOLD_CYCLES = 200_000_000  # ~0.1 s of device sleep ahead of a timed run of launches
WARM_RUNS = 3
DEC_CPU_B, DEC_CPU_T = 8, 2
LATER_BLOCK = 5  # phase 6's second window
DCT_SIZES, DCT_ROWS, DCT_TIMED_ROWS, DCT_TOL = (4096, 8192), 64, 1024, 1e-5
BIG_BS, BIG_B, BIG_T = 4096, 256, 4  # phase 10: stereo bs4096, P=8192
FOLD = 8  # phase 11: all of MAIN_T in one chunk
FLAT_SIZE_REL, FLAT_SNR_DB = 1e-3, 0.3  # phase 11: flat_stream against the block loop
FLAT_BLOCK_BITS, FLAT_N_NZ_SHARE = 64, 0.005  # largest difference of a block, coded counts
ONE_CPU_T = 4  # phase 12: blocks that also go through the CPU port
ONE_T = 64  # phase 12: blocks of the single stream
PIPE_REL, PIPE_LAP = 1e-5, 1e-5  # phase 12: pipelined vs per-block PCM (relative), lap
HUGE_BS, HUGE_B, HUGE_T = 32768, 256, 2  # phase 13: stereo bs32768, P = 65,536
HUGE_PLAIN_B = 13  # phase 13: kernels against their plain versions (on the CPU) at this B,
HUGE_COLS = tuple(range(HUGE_PLAIN_B)) + tuple(range(HUGE_B - 8, HUGE_B))  # and at B = 256 on
# these streams: the first 13 and the last 8 (a whole tile of every kernel)
RATE_BS, RATE_B, RATE_T = 256, 13, 2  # phase 14: the rate paths, stereo bs256
GAP_PLAIN_B = 8  # phase 15: the gap p3 walks on the card and the CPU on 8 streams' planes
SCAN_CHAN, SCAN_BS, SCAN_B, SCAN_T = 16, 2048, 13, 2  # phase 18: P = 32768 on the scan plan
SCAN_KERNEL_B = 8  # phase 18: streams also coded on the kernel path's plan
ONE_BLOCKS = 12  # phase 18: flagship blocks through encode_block and decode_block
TOOL_SECONDS, TOOL_FILES = 30, 4  # phase 16: seconds of audio a WAV, WAVs for the batch tool
PROFILE_BLOCKS = 8  # phase 16: the -profile: run's WAV
# phase 16: the batch tool's figure over the same four files when it did not
# pad them, on the scan path's plan (PERF.md, "Findings")
SCAN_PLAN_BATCH_RTF = "10.5x realtime aggregate (11.40 s) [NVIDIA H100 80GB HBM3, 700.00 W]"
CKPT_T = 32  # phase 16: blocks encoded across a checkpoint
MESH_MAX_RANKS = 4  # phase 17: ranks of the torchrun mesh, a card each where there are cards
MESH_RUNS = 3  # phase 17: timed runs of the torchrun mesh
MESH_TIMEOUT_S = 400  # phase 17: limit of each torchrun
ENTRY_BS = 1024  # phase 17: entry()'s block size
NAMES_TIMED = 9  # phase 19: warm calls of each search, their median kept
FRAME_ROWS = {2048: 16, 32768: 4}  # phase 19: frames of each size, an overlap pair a row
FRAME_TOL, EMA_TOL = 1e-5, 3e-5  # phase 19: card vs CPU, of the largest magnitude
IMDCT_SHAPES = ((8192, 2, 2048), (256, 2, 32768))  # phase 20: (B, C, N), the decode cell's and P = 65,536
# phase 20 and the card test: imdct against its plain version, of each row's peak. The
# FFT rounds otherwise than the dense products (3.5e-6 at most read on the card); 1e-5 is
# the bound of the other fast backends against the dense one (DCT_TOL)
IMDCT_TOL = 1e-5
IMDCT_TIMED = 20  # phase 20: timed launches of the kernel
IMDCT_MAIN = "B=8192 C=2 N=2048 every pattern"  # phase 20's row in the kernels JSON line
IMDCT_SOURCE = "ulcx_torch/csrc/imdct.cu"
PCM_RMS = 1e-5  # card vs CPU, kernels vs plain: float32 products and FFTs sum in other orders
MIN_SNR_DB = 12.0  # the corpus round-trips at ~16.5 dB at CBR-128; far below means broken
SOURCE = "ulcx_torch/csrc/encode_walks.cu"
DEC_SOURCE = "ulcx_torch/csrc/decode_walks.cu"
REPLACES = {
    "p1": "ulcx/bitstream/pallas_encode3.py:124",
    "p2": "ulcx/bitstream/pallas_encode3.py:186",
    "p3_size": "ulcx/bitstream/pallas_encode3.py:254",
    "p3_materialize": "ulcx/bitstream/pallas_encode3.py:254",
    "fsm": "ulcx/bitstream/pallas_decode.py:99",
    "fsm_place": "ulcx/bitstream/pallas_decode.py:99 with the placement "
                 "ulcx/bitstream/fast_decode.py:88",
    "rng_expand": "ulcx/bitstream/pallas_decode.py:393",
    "rng": "ulcx/bitstream/pallas_decode.py:346",
}
REDESIGNED = {"p1": "PR 4", "p2": "PR 3", "p3_size": "PR 3", "p3_materialize": "PR 3",
              "fsm": "PR 5", "fsm_place": "PR 5", "rng_expand": "PR 4", "rng": "PR 4"}
NOTES = {
    "fsm": "on the single-block decoder (decode_block, phase 18): launches are that run's",
    "rng": "not on a main path: held against its plain version only",
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
RAGGED_B, RAGGED_BS, RAGGED_CHAN = 13, 256, 3
# walk launches of one CBR block step: p1 and p2 once a size round and
# once for the final round, p3 size once a size round, p3 materialize once
PER_BLOCK = {"p1": 3, "p2": 3, "p3_size": 2, "p3_materialize": 1}  # seeded ladder, P <= 32768
# rate_search_fast: the seeded ladder with a size-only final round, P >= 512
RATE_SEARCH_FAST = {"p1": 3, "p2": 3, "p3_size": 3, "p3_materialize": 0}
# the scan path's exact ladder: ceil(log16 P) rounds of sixteen candidates, each
# two rounds of the walks' eight, then the count materialized; P = 32768 and 65,536
SCAN_PER_BLOCK = {"p1": 9, "p2": 9, "p3_size": 8, "p3_materialize": 1}
HUGE_PER_BLOCK = SCAN_PER_BLOCK  # P = 65,536 has no kernel plan
BISECT_PER_BLOCK = {"p1": 11, "p2": 11, "p3_size": 10, "p3_materialize": 1}  # bisect, P = 512
# gap noise window at P = 4096: the scan path's ladder (3 rounds of sixteen) and the
# materialization launch p1 and p2; both p3 walks run their plain gap mode (no kernel)
GAP_PER_BLOCK = {"p1": 7, "p2": 7, "p3_size": 0, "p3_materialize": 0}
ONE_BLOCK_PER_BLOCK = {"p1": 7, "p2": 7, "p3_size": 6, "p3_materialize": 1}  # scan path, P = 4096
DEC_PER_BLOCK = {"fsm": 0, "fsm_place": 1, "rng_expand": 1, "rng": 0}
DEC_BLOCK_PER_BLOCK = {"fsm": 1, "fsm_place": 0, "rng_expand": 1, "rng": 0}  # decode_block
IMDCT_PER_BLOCK = 1  # the inverse transform's kernel, once a block_imdct_batched call
TRUNCATED_BYTES = 48  # ~94 tokens, fewer than any block needs


_PHASE = {"name": None, "t0": 0.0}


def phase(name):
    """Print the phase's heading, and the seconds the one before took."""
    now = time.perf_counter()
    if _PHASE["name"]:
        print(f"--- {_PHASE['name']}: {now - _PHASE['t0']:.1f} s", flush=True)
    _PHASE["name"], _PHASE["t0"] = name, now
    if name:
        print(f"--- {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def analyze(x, cfg, device):
    """Analyse x [B, T, 2, N] (numpy) on ``device`` from a fresh carry:
    (the last block's AnalyzedBlock, n_nz [B, T] on the CPU)."""
    import torch

    from ulcx_torch.analysis.batched import analyze_block_batched
    from ulcx_torch.codec.encoder import init_carry_batched

    blocks = torch.from_numpy(x).to(device)
    carry = init_carry_batched(cfg, blocks.shape[0], device)
    n_nz = []
    for j in range(blocks.shape[1]):
        carry, blk = analyze_block_batched(carry, blocks[:, j], cfg)
        n_nz.append(blk.n_nz.cpu())
    return blk, torch.stack(n_nz, dim=1)


def io_bytes(args, out):
    """Bytes of a call's tensor inputs and outputs, each counted once."""
    import torch

    out = out if isinstance(out, tuple) else (out,)
    return sum(x.nbytes for x in (*args, *out) if isinstance(x, torch.Tensor))


def take_cols(x, b, cols):
    """Streams ``cols`` of a tensor of a batch of ``b`` streams, along
    its one axis of length b (anything else as it is)."""
    import torch

    if not isinstance(x, torch.Tensor) or cols is None:
        return x
    axes = [i for i, n in enumerate(x.shape) if n == b]
    if len(axes) != 1:
        raise AssertionError(f"no single batch axis of length {b} in shape {tuple(x.shape)}")
    return x.index_select(axes[0], torch.as_tensor(cols, device=x.device)).contiguous()


def run_plain(plain, args, plain_device, b=None, cols=None):
    """(output, ms) of one plain call: on the kernel's device, timed with
    CUDA events, or on ``plain_device`` (the CPU) on copies of the
    arguments, timed on the host's clock; with ``cols``, on those
    streams of the batch of ``b`` only."""
    import torch

    args = tuple(take_cols(a, b, cols) for a in args)
    if plain_device is None:
        return timed(plain, args, 1)
    args = tuple(a.to(plain_device) if isinstance(a, torch.Tensor) else a for a in args)
    t0 = time.perf_counter()
    out = plain(*args)
    return out, (time.perf_counter() - t0) * 1e3


def kernels_vs_plain(cfg, x, device, overflow_words=False, plain_device=None, cols=None):
    """Phase 3: every kernel against its plain version on the planes of
    one block step, and with ``overflow_words`` p3 materialize once more
    into a word buffer most streams overflow; returns {name: (max_abs_err,
    kernel ms, plain ms, bytes)}. ``plain_device`` runs the plain
    versions there, on copies of the planes; ``cols`` runs them on those
    streams only (streams are independent) and compares the kernel's
    outputs there."""
    import torch

    from ulcx_torch.bitstream import encode_kernels as ek
    from ulcx_torch.bitstream import fast_encode as fe
    from ulcx_torch.codec.encoder import max_block_bytes

    blk, _ = analyze(x, cfg, device)
    fb = fe.prepare_fast(blk, cfg)
    pl = fe.make_planes(fb)
    # the first ladder round's candidates: n_nz * (1..8) / 8
    steps = torch.arange(1, fe.N_CAND + 1, dtype=torch.int32, device=device)
    nn = ((blk.n_nz[:, None] + fe.N_CAND - 1) // fe.N_CAND) * steps
    nn = torch.minimum(nn, blk.n_nz[:, None]).to(torch.int32)
    t, c = fe._tc_of(pl, nn)
    n_words = max_block_bytes(cfg) // 4
    calls = {
        "p1": (ek.p1, ek.p1_plain, lambda: (t, c, pl.key, pl.coef, pl.aux)),
        "p2": (ek.p2, ek.p2_plain, lambda: (t, c, pl.key, pl.thr, pl.aux, s12)),
        "p3_size": (ek.p3_size, ek.p3_size_plain, lambda: (pl.thr, pl.aux, state)),
        "p3_materialize": (
            ek.p3_materialize, ek.p3_materialize_plain,
            lambda: (pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.aux, state, pl.hdr, n_words),
        ),
    }

    results = {}
    s12 = state = None
    b = blk.n_nz.shape[0]
    where = f" on the {plain_device}" if plain_device else ""
    on_cols = f" on {len(cols)} of {b} streams" if cols is not None else ""
    for name, (kernel, plain_fn, make_args) in calls.items():
        args = make_args()
        for _ in range(WARMUP_LAUNCHES):
            kernel(*args)
        got, ms = timed(kernel, args, TIMED_LAUNCHES)
        got = got if isinstance(got, tuple) else (got,)
        want, plain_ms = run_plain(plain_fn, args, plain_device, b, cols)
        want = want if isinstance(want, tuple) else (want,)
        err = 0
        for w, g in zip(want, got):
            g = take_cols(g, b, cols).to(w.device)
            if w.shape != g.shape or w.dtype != g.dtype:
                raise AssertionError(f"{name}: {g.shape} {g.dtype} vs plain {w.shape} {w.dtype}")
            err = max(err, int((g.long() - w.long()).abs().max()))
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain version by {err}")
        results[name] = (err, ms, plain_ms, io_bytes(args, got))
        print(f"{name}: identical to plain{on_cols}; kernel {ms:.4f} ms, plain{where} "
              f"{plain_ms:.1f} ms", flush=True)
        if name == "p1":
            s12 = got[0]
        elif name == "p2":
            state = got[0]
    if overflow_words:
        args = (pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.aux, state, pl.hdr, 6)
        for w, g in zip(ek.p3_materialize_plain(*args), ek.p3_materialize(*args)):
            if not torch.equal(w, g):
                raise AssertionError("p3_materialize (n_words=6): kernel differs from plain")
        print("p3_materialize n_words=6: identical to plain", flush=True)
    return results


def ragged_corpus():
    """RAGGED_B streams x 2 blocks of 3 channels at bs256: the corpus is
    stereo, so the third channel is a scaled copy of the first."""
    import numpy as np

    from bench import make_corpus

    x = make_corpus(RAGGED_B, 2, RAGGED_BS)
    return np.ascontiguousarray(np.concatenate([x, 0.5 * x[:, :, :1]], axis=2), np.float32)


def timed(fn, args, reps):
    """(last output, ms per call) over ``reps`` back-to-back calls,
    timed with CUDA events. With reps > 1 (a kernel's launches) the
    device first sleeps while the host queues them, so a host slower
    than the kernel (a shared machine's cores) adds no gaps between
    launches to the time."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if reps > 1:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def check_encoded(sizes, data, b, t, cfg, label):
    """Every block within the CBR budget, and no byte set past its size."""
    import torch

    from ulcx_torch.codec.encoder import cbr_bit_budget

    budget = int(cbr_bit_budget(cfg, RATE_KBPS))
    if tuple(sizes.shape) != (b, t):
        raise AssertionError(f"{label}: size_bits shape {tuple(sizes.shape)}")
    if int(sizes.max()) > budget or int(sizes.min()) <= 0:
        raise AssertionError(f"{label}: block sizes outside (0, {budget}]: "
                             f"{int(sizes.min())}..{int(sizes.max())}")
    pos = torch.arange(data.shape[-1], device=sizes.device) * 8
    if bool(((pos >= sizes[..., None]) & (data != 0)).any()):
        raise AssertionError(f"{label}: bytes set past a block's size")


def main_path(cfg, x, device, stage_runs=None, per_block=PER_BLOCK, mesh=None):
    """Phase 4 (and 10, 11, 13, 15, 17): returns (launch counts, warm
    seconds of each repeat, seconds of audio, the encoded blocks).
    ``stage_runs`` is how often the bitstream stages run: once a block
    unless ``cfg`` folds them; ``per_block`` the launches of one run.
    With a ``mesh`` (a world of one) the total is its float32 form."""
    import torch

    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.parallel.mesh import batch_encode

    blocks = torch.from_numpy(x).to(device)
    b, t = blocks.shape[:2]
    reset_launch_counts()
    t0 = time.perf_counter()
    out, stats = batch_encode(blocks, cfg, "cbr", rate_kbps=RATE_KBPS, mesh=mesh)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = launch_counts(*PER_BLOCK)
    if mesh is not None and not (stats["total_bits"].dtype == torch.float32 and torch.equal(
            stats["total_bits"], torch.sum(out.size_bits).to(torch.float32))):
        raise AssertionError(f"mesh total {stats['total_bits']} is not the float32 sum")
    want = {k: (t if stage_runs is None else stage_runs) * v for k, v in per_block.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    check_encoded(out.size_bits, out.data, b, t, cfg, "main path")

    warm = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        again, _ = batch_encode(blocks, cfg, "cbr", rate_kbps=RATE_KBPS, mesh=mesh)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if not (torch.equal(out.data, again.data) and torch.equal(out.size_bits, again.size_bits)):
            raise AssertionError("a second run gave other bytes")
    print(f"encode B={b} T={t}: cold {cold:.3f} s, warm {', '.join(f'{w:.3f}' for w in warm)} s, "
          f"total {int(stats['total_bits'])} bits, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return counts, warm, b * t * cfg.block_size / cfg.rate_hz, out


def cuda_vs_cpu(cfg, x, devices=("cuda", "cpu")):
    """Phase 5: the CPU port (plain walks) against the card."""
    import torch

    from ulcx_torch.parallel.mesh import batch_encode

    res = {}
    for dev in devices:
        out, _ = batch_encode(x, cfg, "cbr", rate_kbps=RATE_KBPS, device=dev)
        res[dev] = (out.window_ctrl.cpu(), analyze(x, cfg, dev)[1], out.size_bits.cpu(),
                    out.data.cpu())
    (wg, ng, sg, dg), (wc, nc, sc, dc) = (res[d] for d in devices)
    check_encoded(sc, dc, x.shape[0], x.shape[1], cfg, "cpu port")
    if not torch.equal(wg, wc):
        raise AssertionError(f"window_ctrl differs:\n{wg}\n{wc}")
    if not torch.equal(ng, nc):
        raise AssertionError(f"n_nz differs:\n{ng}\n{nc}")
    tot_g, tot_c = int(sg.sum()), int(sc.sum())
    rel = abs(tot_g - tot_c) / tot_c
    if rel > 0.01:
        raise AssertionError(f"total bits {tot_g} (cuda) vs {tot_c} (cpu): {rel:.4%}")
    same = sum(torch.equal(dg[i, j], dc[i, j]) for i in range(x.shape[0]) for j in range(x.shape[1]))
    print(f"cuda vs cpu B={x.shape[0]} T={x.shape[1]}: window_ctrl and n_nz equal, total bits "
          f"{tot_g} vs {tot_c} ({rel:.4%}), {same}/{x.shape[0] * x.shape[1]} blocks "
          f"byte-identical", flush=True)


def pack_streams(out):
    """Encoded blocks [B, T] -> (streams [B, S] uint8, block byte offsets
    [B, T], window bytes, size_bits [B, T]), all on the CPU, as
    bench.py:240-247 packs them: the window is the largest block rounded
    up to 64 bytes, plus 64."""
    import numpy as np
    import torch

    sizes, datas = out.size_bits.cpu().numpy(), out.data.cpu().numpy()
    b, t = sizes.shape
    win = -(-int(sizes.max() // 8) // 64) * 64 + 64
    streams = np.zeros((b, t * win + win + 64), np.uint8)
    offs = np.zeros((b, t), np.int64)
    for i in range(b):
        off = 0
        for j in range(t):
            nb = int(sizes[i, j]) // 8
            offs[i, j] = off
            streams[i, off : off + nb] = datas[i, j, :nb]
            off += nb
    return torch.from_numpy(streams), torch.from_numpy(offs), win, torch.from_numpy(sizes)


def decode_vs_plain(name, kernel, plain, args, label, plain_device=None, cols=None):
    """One decode kernel against its plain version (floats compared as
    bits), both timed: (max_abs_err, kernel ms, plain ms, bytes); the
    plain version on ``plain_device`` when one is given, on copies, and
    on the streams ``cols`` only when they are given."""
    import torch

    for _ in range(WARMUP_LAUNCHES):
        kernel(*args)
    got, ms = timed(kernel, args, TIMED_LAUNCHES)
    b = args[0].shape[-1]  # wc [B] or flags [P, B]
    want, plain_ms = run_plain(plain, args, plain_device, b, cols)
    err = 0.0
    for w, g in zip(want, got):
        g = take_cols(g, b, cols).to(w.device)
        if w.shape != g.shape or w.dtype != g.dtype:
            raise AssertionError(f"{name}: {g.shape} {g.dtype} vs plain {w.shape} {w.dtype}")
        if g.dtype == torch.float32:
            err = max(err, float((g - w).abs().max()))
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            same = torch.equal(g, w)
        if not same:
            raise AssertionError(f"{name} ({label}): kernel differs from its plain version "
                                 f"(max abs err {err})")
    on_cols = f" on {len(cols)} of {b} streams" if cols is not None else ""
    print(f"{name} {label}: identical to plain (bits){on_cols}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms", flush=True)
    return (err, ms, plain_ms, io_bytes(args, got)), got


def stream_seeds(b, seed):
    """[B] int32 RNG seeds holding u32 bits, every other one with bit 31 set."""
    import numpy as np
    import torch

    s = np.random.default_rng(seed).integers(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
    s[1::2] |= np.uint32(1 << 31)
    return torch.from_numpy(s.view(np.int32))


def decode_kernels_vs_plain(cfg, streams, offs, win, device, blocks=(0, LATER_BLOCK),
                            plain_device=None, cols=None):
    """Phase 6: each decode kernel against its plain version on the
    windows of ``blocks`` (the plain versions on ``plain_device`` when
    one is given, on the streams ``cols`` when they are given); returns
    {name: (max_abs_err, kernel ms, plain ms, bytes)} for block 0."""
    import torch

    from ulcx_torch.bitstream import decode_kernels as dk
    from ulcx_torch.bitstream import fast_decode as fd

    p_tot = cfg.n_chan * cfg.block_size
    results = {}
    for blk in blocks:
        windows = torch.gather(streams, 1, offs[:, blk : blk + 1] + torch.arange(win)).to(device)
        wc, _, tokens = fd._header_and_tokens(windows)
        seed = stream_seeds(windows.shape[0], blk).to(device)
        fsm_args = (wc, tokens, p_tot, cfg.block_size)
        flags, _, corrupt = dk.fsm_place(*fsm_args)
        if bool(corrupt.any()):
            raise AssertionError(f"block {blk}: {int(corrupt.sum())} windows decode as corrupt")
        calls = {
            "fsm": (dk.fsm, dk.fsm_plain, fsm_args),
            "fsm_place": (dk.fsm_place, dk.fsm_place_plain, fsm_args),
            "rng_expand": (dk.rng_expand, dk.rng_expand_plain, (flags, seed)),
            "rng": (dk.rng, dk.rng_plain, (dk.rng_flags(flags), seed)),
        }
        for name, (kernel, plain_fn, args) in calls.items():
            res, _ = decode_vs_plain(name, kernel, plain_fn, args, f"block {blk}", plain_device,
                                     cols)
            if blk == 0:
                results[name] = res
    return results


def all_coef_window(rng, n, n_chan, w, wc_nybbles):
    """A window of w bytes whose every segment is coded coefficient by
    coefficient: the header nybbles, then per segment a quantizer nybble
    and one coefficient nybble per position. It ends after n_chan *
    (segments + n) tokens."""
    import numpy as np

    from ulcx_torch.ops.patterns import pattern_subblock_sizes

    pat = (wc_nybbles[1] if len(wc_nybbles) == 2 else 1) or 1
    ny = list(wc_nybbles)
    for _ in range(n_chan):
        for ss in pattern_subblock_sizes(pat, n):
            ny.append(int(rng.integers(0, 14)))
            ny.extend(rng.choice([2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14], ss).tolist())
    ny = np.array(ny + [0] * (2 * w - len(ny)), np.uint8)
    return ny[0::2] | (ny[1::2] << 4)


def fsm_vs_plain_synthetic(cfg, streams, win, device):
    """Phase 6: both FSM modes against their plain versions at B =
    RAGGED_B on windows the encoder never writes: (a) random bytes under
    headers of patterns 0-7 and real windows whose second half is random
    (corrupt mid-block, the records before kept); (b) real windows cut
    to TRUNCATED_BYTES (every token read, no end); (c) all-coefficient
    windows of patterns 3-15, ~4,100 tokens each."""
    import numpy as np
    import torch

    from ulcx_torch.bitstream import decode_kernels as dk
    from ulcx_torch.bitstream import fast_decode as fd

    b, n, p_tot = RAGGED_B, cfg.block_size, cfg.n_chan * cfg.block_size
    rng = np.random.default_rng(16)
    real = streams[:b, :win].numpy()
    broken = rng.integers(0, 256, (b, win)).astype(np.uint8)
    broken[:8, 0] = 0x8 | (np.arange(8) << 4)  # 2-nybble headers, patterns 0-7
    broken[8:, : win // 4] = real[8:, : win // 4]
    w_long = p_tot // 2 + 32
    long = np.stack([all_coef_window(rng, n, cfg.n_chan, w_long, [0x8, 3 + i]) for i in range(b)])
    cases = {"random": broken, "truncated": real[:, :TRUNCATED_BYTES].copy(),
             "all-coefficient": long}
    patterns = set()
    for label, windows in cases.items():
        wc, _, tokens = fd._header_and_tokens(torch.from_numpy(windows).to(device))
        patterns |= set(((wc >> 4) & 15).tolist())
        args = (wc, tokens, p_tot, n)
        label = f"{label} windows B={b} T={tokens.shape[0]}"
        _, (rec, _, consumed, corrupt) = decode_vs_plain("fsm", dk.fsm, dk.fsm_plain, args, label)
        _, (flags, consumed_p, corrupt_p) = decode_vs_plain(
            "fsm_place", dk.fsm_place, dk.fsm_place_plain, args, label)
        if not (torch.equal(consumed, consumed_p) and torch.equal(corrupt, corrupt_p)):
            raise AssertionError(f"{label}: the FSM's two modes disagree on consumed or corrupt")
        records = ((rec >> dk.REC_START_BITS) != 0).sum(0)
        if not torch.equal(records, (flags & 1).sum(0)):
            raise AssertionError(f"{label}: the flags hold other records than the record plane")
        consumed, corrupt, records = consumed.cpu(), corrupt.cpu(), records.cpu()
        if label.startswith("random"):
            ok = bool(corrupt.any()) and bool((records[corrupt == 1] > 0).any()) \
                and bool((consumed[corrupt == 1] < tokens.shape[0]).any())
        elif label.startswith("truncated"):
            ok = bool((corrupt == 1).all()) and bool((consumed == tokens.shape[0]).all())
        else:
            ok = not bool(corrupt.any()) and bool((consumed > p_tot).all()) \
                and bool((records == p_tot).all())
        if not ok:
            raise AssertionError(f"{label}: consumed {consumed.tolist()}, corrupt "
                                 f"{corrupt.tolist()}, records {records.tolist()}")
    if patterns != set(range(16)):
        raise AssertionError(f"window patterns {sorted(patterns)}: not all 16")


def synthetic_flags(rng, n_pos, b):
    """Records tiling [P, B] at random: single coefficients, zero runs,
    noise runs and tail runs, with random codes; stream 0 starts with a
    long steep tail whose magnitude decays below the normal range (to 0
    after ~660 positions). Returns expansion flags [P, B] i32."""
    import numpy as np

    flags = np.zeros((n_pos, b), np.int32)
    for i in range(b):
        p = 0
        while p < n_pos:
            kind = rng.integers(0, 4)
            a, dn, qi = int(rng.integers(0, 32)), int(rng.integers(0, 256)), int(rng.integers(0, 32))
            length = 1 if kind == 0 else int(rng.integers(1, 300))
            if i == 0 and p == 0:
                kind, a, dn, qi, length = 3, 16, 255, 0, 1500  # decays to 0 after ~660
            draw = kind in (2, 3)
            code = a | (dn << 5) | (qi << 13)
            flags[p, i] = 1 | (draw << 1) | ((kind == 0) << 2) | ((kind == 3) << 3) | (code << 4)
            p += length
    return flags


def rng_vs_plain_synthetic(n_pos, b, device):
    """Phase 6: RNG-expand and RNG against their plain versions on
    ``synthetic_flags``; the steep tail must decay through the flush."""
    import numpy as np
    import torch

    from ulcx_torch.bitstream import decode_kernels as dk

    flags = torch.from_numpy(synthetic_flags(np.random.default_rng(6), n_pos, b)).to(device)
    seed = stream_seeds(b, 6).to(device)
    label = f"synthetic tail flags B={b} P={n_pos}"
    _, (coef, _) = decode_vs_plain("rng_expand", dk.rng_expand, dk.rng_expand_plain,
                                   (flags, seed), label)
    decode_vs_plain("rng", dk.rng, dk.rng_plain, (dk.rng_flags(flags), seed), label)
    tail = coef[:1500, 0].cpu()
    if not (bool((tail[:600] != 0).all()) and bool((tail[700:] == 0).all())):
        raise AssertionError("the synthetic tail does not decay through the flush")


def decode_snr(x, pcm):
    """Round-trip SNR in dB of decoded block t against input block t-1,
    over blocks 1..T-1 (the codec delays by one block)."""
    import numpy as np

    want = x[:, : pcm.shape[1] - 1].astype(np.float64)
    err = pcm[:, 1:].astype(np.float64) - want
    return 10 * np.log10((want ** 2).sum() / (err ** 2).sum())


def decode_main_path(cfg, x, streams, win, sizes, device, mesh=None, min_snr=MIN_SNR_DB):
    """Phase 7 (and 10, 13, 15, 17, 18): returns (launch counts, warm
    seconds of each repeat, seconds of audio, round-trip SNR in dB, (pcm,
    bits, corrupt)); ``min_snr`` None checks no SNR floor."""
    import torch

    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.parallel.mesh import batch_decode

    b, t = sizes.shape
    s_dev = streams.to(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    pcm, bits, corrupt = batch_decode(s_dev, t, win, cfg, mesh=mesh)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = launch_counts(*DEC_PER_BLOCK, "imdct")
    want = {**{k: t * v for k, v in DEC_PER_BLOCK.items()}, "imdct": t * IMDCT_PER_BLOCK}
    if counts != want:
        raise AssertionError(f"decode launch counts {counts}, expected {want}")
    if bool(corrupt.any()):
        raise AssertionError(f"{int(corrupt.sum())} blocks decode as corrupt")
    if not torch.equal(((bits + 7) // 8 * 8).cpu(), sizes):
        raise AssertionError("decoded bits, rounded up to bytes, differ from the encoded sizes")
    if tuple(pcm.shape) != (b, t, cfg.n_chan, cfg.block_size) or not bool(torch.isfinite(pcm).all()):
        raise AssertionError(f"pcm {tuple(pcm.shape)} not finite or of the wrong shape")
    warm = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        again = batch_decode(s_dev, t, win, cfg, mesh=mesh)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if not all(torch.equal(u, v) for u, v in zip((pcm, bits, corrupt), again)):
            raise AssertionError("a second decode gave other results")
    snr = decode_snr(x, pcm.cpu().numpy())
    if min_snr is not None and not snr > min_snr:
        raise AssertionError(f"round-trip SNR {snr:.2f} dB, expected above {min_snr} dB")
    print(f"decode B={b} T={t} window {win} bytes: cold {cold:.3f} s, warm "
          f"{', '.join(f'{w:.3f}' for w in warm)} s, round-trip SNR {snr:.2f} dB", flush=True)
    return counts, warm, b * t * cfg.block_size / cfg.rate_hz, snr, (pcm, bits, corrupt)


def decode_cuda_vs_cpu(cfg, streams, win, devices=("cuda", "cpu")):
    """Phase 8: the first streams and blocks through the CPU port (plain
    kernels) against the card."""
    import torch

    from ulcx_torch.parallel.mesh import batch_decode

    res = {dev: [y.cpu() for y in batch_decode(streams[:DEC_CPU_B], DEC_CPU_T, win, cfg, device=dev)]
           for dev in devices}
    (pcm_g, bits_g, corrupt_g), (pcm_c, bits_c, corrupt_c) = (res[d] for d in devices)
    if not (torch.equal(bits_g, bits_c) and torch.equal(corrupt_g, corrupt_c)):
        raise AssertionError(f"bits or corrupt differ:\n{bits_g}\n{bits_c}")
    if bool(corrupt_c.any()):
        raise AssertionError("the CPU port decodes corrupt blocks")
    rms = float(torch.sqrt(torch.mean((pcm_g - pcm_c) ** 2)))
    if rms > PCM_RMS:
        raise AssertionError(f"pcm differs by {rms:.3g} RMS (limit {PCM_RMS})")
    print(f"decode cuda vs cpu B={DEC_CPU_B} T={DEC_CPU_T}: bits and corrupt equal, pcm "
          f"{rms:.3g} RMS apart", flush=True)


def refuse_other_geometry(lib):
    """Every entry point that takes a launch geometry returns
    cudaErrorInvalidValue (1), launching nothing, when its shared-memory
    bytes differ from the kernel's layout by one 16-byte row."""
    from ulcx_torch._build import _SIGNATURES
    from ulcx_torch.bitstream import decode_kernels as dk
    from ulcx_torch.bitstream import encode_kernels as ek
    from ulcx_torch.codec import transform_batched as tb

    b, n_pos = MAIN_B, 2 * BS
    cases = {f"ulcx_{k}": (b, n_pos, *ek._geometry_ints(k, n_pos, b))
             for k in ("p1", "p2", "p3_size")}
    cases["ulcx_p3_materialize"] = (b, n_pos, 64, *ek._geometry_ints("p3_materialize", n_pos, b))
    t_len = 2 * 832 - 2
    cases["ulcx_fsm"] = (b, t_len, n_pos, BS, *dk._fsm_geometry_ints(t_len, b))
    cases["ulcx_fsm_place"] = cases["ulcx_fsm"]
    cases["ulcx_rng_expand"] = (b, n_pos, *dk._rng_geometry_ints(n_pos, b, True))
    cases["ulcx_rng"] = (b, n_pos, *dk._rng_geometry_ints(n_pos, b, False))
    g = tb.imdct_geometry(b, 2, BS)
    cases["ulcx_imdct"] = (b, 2, BS, g["threads"], tb.lap_tables(BS, "cpu").numel(), 2 * BS - 2,
                           tb.dct4_twiddle_table(BS).shape[0], g["shared"])
    for name, ints in cases.items():
        rc = getattr(lib, name)(*[None] * _SIGNATURES[name][0], *ints[:-1], ints[-1] + 16, None)
        if rc != 1:
            raise AssertionError(f"{name} took a geometry 16 bytes off its layout (rc {rc})")
    print(f"geometry: {', '.join(cases)} refuse shared memory off their layout", flush=True)


def rtf_line(label, warm, audio_s, counts, card):
    """Print and return the realtime factor at the median warm run."""
    med = sorted(warm)[len(warm) // 2]
    print(f"{label} realtime factor {audio_s / med:.1f}x (median of {len(warm)}: {audio_s:.1f} s "
          f"of audio in {med:.3f} s), launches {counts} [{card}]", flush=True)
    return audio_s / med


def transforms_on_card(device, card):
    """Phase 9: fact and fft against the dense backend, then all three
    timed."""
    import torch

    from ulcx_torch.ops import dct

    gen = torch.Generator(device="cpu").manual_seed(9)
    for n in DCT_SIZES:
        xc, xs = (torch.randn(DCT_ROWS, n, generator=gen).to(device) for _ in range(2))
        want_c, want_s = dct.dct4(xc, "matmul"), dct.dst4(xs, "matmul")
        worst = {}
        for backend in ("fact", "fft"):
            pair = dct.dct4_dst4(xc, xs, backend)
            got = {"dct4": (dct.dct4(xc, backend), want_c), "dst4": (dct.dst4(xs, backend), want_s),
                   "pair dct4": (pair[0], want_c), "pair dst4": (pair[1], want_s)}
            for name, (g, w) in got.items():
                if g.shape != w.shape or g.dtype != torch.float32:
                    raise AssertionError(f"{backend} {name} N={n}: {g.shape} {g.dtype}")
                rel = float(((g - w).abs() / w.abs().amax(-1, keepdim=True)).max())
                if not rel <= DCT_TOL:
                    raise AssertionError(f"{backend} {name} N={n}: {rel:.3g} of the block maximum "
                                         f"from the dense backend (limit {DCT_TOL})")
                worst[backend] = max(worst.get(backend, 0.0), rel)
        x = torch.randn(DCT_TIMED_ROWS, n, generator=gen).to(device)
        ms = {}
        for backend in ("matmul", "fact", "fft"):
            for _ in range(3):
                dct.dct4_dst4(x, x, backend)
            _, ms[backend] = timed(dct.dct4_dst4, (x, x, backend), 20)
        print(f"N={n}: fact within {worst['fact']:.2e}, fft within {worst['fft']:.2e} of the block "
              f"maximum from matmul; dct4+dst4 pair of [{DCT_TIMED_ROWS}, {n}]: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()) + f" [{card}]", flush=True)


def imdct_inputs(b, c, n, device, seed, long_blocks=False):
    """Inputs of ``transform_batched.imdct`` for b streams: coefficients
    [b, c, n] and a lap, normal random values, and per stream a window
    control and a previous last subblock size. With ``long_blocks`` every
    block is a long one after a long one (pattern 0, prev_last_ss = n:
    the decode cell's steady state); else stream i takes the i-th
    (pattern, scale, prev_last_ss) of the 16 x 8 x 5 grid of every
    pattern, transient scale and prev_last_ss in {0, n, n/2, n/4, n/8}
    (640 streams cover it), in an order drawn from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    if long_blocks:
        wc, prev = np.zeros(b, np.int32), np.full(b, n, np.int32)
    else:
        grid = np.stack(np.meshgrid(np.arange(16), np.arange(8), np.arange(5), indexing="ij"), -1)
        grid = grid.reshape(-1, 3)
        pick = np.concatenate([rng.permutation(len(grid)) for _ in range(-(-b // len(grid)))])[:b]
        if b >= len(grid):
            pick[:len(grid)] = np.arange(len(grid))
        pat, scale, which = grid[pick].T
        wc = (pat << 4 | scale).astype(np.int32)
        prev = np.array([0, n, n // 2, n // 4, n // 8], np.int32)[which]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    coefs = torch.randn(b, c, n, generator=gen).to(device)
    lap = torch.randn(b, c, n // 2, generator=gen).to(device)
    return coefs, torch.from_numpy(wc).to(device), lap, torch.from_numpy(prev).to(device)


def imdct_gap(got, want):
    """(largest gap of pcm and lap over each row's peak, share of values
    bit-equal, last_ss equal) of the kernel's outputs against the plain
    version's."""
    import torch

    gap, same, n_vals = 0.0, 0, 0
    for g, w in zip(got[:2], want[:2]):
        w = w.contiguous()
        peak = w.abs().amax(-1, keepdim=True).clamp(min=torch.finfo(torch.float32).tiny)
        gap = max(gap, float(((g - w).abs() / peak).max()))
        same += int((g.view(torch.int32) == w.view(torch.int32)).sum())
        n_vals += w.numel()
    return gap, same / n_vals, torch.equal(got[2], want[2])


def imdct_bytes(b, c, n):
    """Bytes the kernel needs: the coefficients and the lap read, PCM and
    lap written, 12 n a row."""
    return 12 * n * b * c


def imdct_on_card(device, card):
    """Phase 20: the inverse transform's kernel. At the decode cell's
    shape (B = 8192, C = 2, N = 2048) and at P = 65,536 (B = 256,
    N = 32768), on every pattern and on long blocks only: PCM and lap
    within IMDCT_TOL of each row's peak of the plain version's on the card
    (the class GEMMs and ``imdct_lap_plain``), last_ss exact, one launch a
    call; both timed, the kernel beside its byte bound. Returns {label:
    (gap, ms, plain ms, bytes)}."""
    import torch

    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.codec import transform_batched as tb
    from ulcx_torch.utils.config import CodecConfig

    transform_for = CodecConfig().transform_for
    out = {}
    for b, c, n in IMDCT_SHAPES:
        for long_blocks in (False, True):
            args = (*imdct_inputs(b, c, n, device, seed=b + n, long_blocks=long_blocks),
                    transform_for)
            reset_launch_counts()
            got = tb.imdct(*args)
            torch.cuda.synchronize()
            if launch_counts("imdct") != {"imdct": 1}:
                raise AssertionError(f"imdct launched {launch_counts('imdct')}, expected once")
            want = tb.imdct_plain(*args)
            gap, same, last_ok = imdct_gap(got, want)
            if not (gap <= IMDCT_TOL and last_ok):
                raise AssertionError(f"imdct B={b} C={c} N={n}: {gap:.3g} of the row's peak "
                                     f"from the plain version (limit {IMDCT_TOL}), last_ss equal "
                                     f"{last_ok}")
            del got, want
            for _ in range(3):
                tb.imdct(*args)
            _, ms = timed(tb.imdct, args, IMDCT_TIMED)
            _, plain_ms = timed(tb.imdct_plain, args, 3)
            need = imdct_bytes(b, c, n)
            bound_ms = need / HBM_BYTES_PER_S * 1e3
            label = f"B={b} C={c} N={n} {'long blocks' if long_blocks else 'every pattern'}"
            print(f"imdct {label}: {gap:.2e} of the row's peak from the plain version, "
                  f"{same:.6f} of the values bit-equal, last_ss exact; kernel {ms:.4f} ms, "
                  f"plain (GEMMs) {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({need / 1e6:.1f} "
                  f"MB, {100 * bound_ms / ms:.1f} % of it) [{card}]", flush=True)
            out[label] = (gap, ms, plain_ms, need)
            del args
            torch.cuda.empty_cache()
    return out


def large_blocks(device, card):
    """Phase 10: returns ({kernel: (err, ms, plain ms, bytes)} at
    P = 2 * BIG_BS, B = BIG_B, encode counts, decode counts)."""
    import torch
    from bench import make_corpus
    from ulcx_torch.utils.config import CodecConfig

    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=BIG_BS)
    if cfg.transform_for(BIG_BS) != "fact":
        raise AssertionError("the bs4096 subblock does not take the fact backend")
    x = make_corpus(BIG_B, BIG_T, BIG_BS)
    print(f"B={BIG_B}, P={2 * BIG_BS}:", flush=True)
    res = kernels_vs_plain(cfg, x[:, :2].copy(), device)
    counts, warm, audio_s, encoded = main_path(cfg, x, device)
    rtf_line(f"bs{BIG_BS} encode", warm, audio_s, counts, card)
    streams, offs, win, sizes = pack_streams(encoded)
    print(f"B={BIG_B}, P={2 * BIG_BS}, window {win} bytes ({2 * win - 2} tokens):", flush=True)
    res.update(decode_kernels_vs_plain(cfg, streams, offs, win, device, blocks=(0, BIG_T - 1)))
    dcounts, dwarm, audio_s, _, _ = decode_main_path(cfg, x, streams, win, sizes, device)
    rtf_line(f"bs{BIG_BS} decode", dwarm, audio_s, dcounts, card)
    return res, counts, dcounts


def flat_n_nz_differs(cfg, x, device) -> int:
    """Blocks of x [B, T, 2, N] whose coded count from the analysis of
    all blocks at once differs from the block-by-block analysis's."""
    import torch

    from ulcx_torch.analysis.batched import analyze_stream_batched
    from ulcx_torch.codec.encoder import init_carry_batched

    blocks = torch.from_numpy(x).to(device)
    b, t = blocks.shape[:2]
    _, flat = analyze_stream_batched(init_carry_batched(cfg, b, device), blocks, cfg)
    return int((flat.n_nz.reshape(b, t).cpu() != analyze(x, cfg, device)[1]).sum())


def folded_encode(cfg, x, ref, ref_snr, device, card):
    """Phase 11: fold_bitstream and flat_stream against phase 4's
    blocks ``ref`` and phase 7's SNR; returns {knob: launch counts}."""
    import dataclasses

    import torch

    from ulcx_torch.parallel.mesh import batch_decode

    t = x.shape[1]
    all_counts = {}
    for label, change, runs in ((f"fold_bitstream={FOLD}", {"fold_bitstream": FOLD}, t // FOLD),
                                ("flat_stream", {"flat_stream": True}, 1)):
        counts, warm, audio_s, out = main_path(dataclasses.replace(cfg, **change), x, device,
                                               stage_runs=runs)
        if not torch.equal(out.window_ctrl, ref.window_ctrl):
            raise AssertionError(f"{label}: window control differs from the block loop's")
        same_size = out.size_bits == ref.size_bits
        same = (out.data == ref.data).all(dim=-1)
        print(f"{label}: window control identical; of {same.numel()} blocks {int(same_size.sum())} "
              f"have the block loop's size and {int(same.sum())} its bytes", flush=True)
        if "fold_bitstream" in change:
            if not (bool(same.all()) and bool(same_size.all())):
                raise AssertionError(f"{label}: bytes or sizes differ from the block loop's")
        else:
            tot, tot_ref = int(out.size_bits.sum()), int(ref.size_bits.sum())
            if abs(tot - tot_ref) > FLAT_SIZE_REL * tot_ref:
                raise AssertionError(f"{label}: total {tot} bits vs the block loop's {tot_ref}")
            worst = int((out.size_bits - ref.size_bits).abs().max())
            if worst > FLAT_BLOCK_BITS:
                raise AssertionError(f"{label}: a block {worst} bits from the block loop's size "
                                     f"(limit {FLAT_BLOCK_BITS})")
            n_nz_differs = flat_n_nz_differs(cfg, x, device)
            if n_nz_differs > FLAT_N_NZ_SHARE * same.numel():
                raise AssertionError(f"{label}: the coded count differs from the block loop's in "
                                     f"{n_nz_differs} of {same.numel()} blocks")
            streams, _, win, sizes = pack_streams(out)
            pcm, bits, corrupt = batch_decode(streams, t, win, cfg)
            if bool(corrupt.any()) or not torch.equal(((bits + 7) // 8 * 8).cpu(), sizes):
                raise AssertionError(f"{label}: its bytes decode corrupt or to other sizes")
            snr = decode_snr(x, pcm.cpu().numpy())
            if abs(snr - ref_snr) > FLAT_SNR_DB:
                raise AssertionError(f"{label}: round-trip SNR {snr:.2f} dB vs {ref_snr:.2f} dB")
            print(f"{label}: total {tot} bits vs {tot_ref} ({(tot - tot_ref) / tot_ref:+.4%}), largest "
                  f"difference of a block {worst} bits, coded count differs in {n_nz_differs} "
                  f"blocks, round-trip SNR {snr:.2f} dB vs {ref_snr:.2f} dB", flush=True)
        rtf_line(f"{label} encode", warm, audio_s, counts, card)
        all_counts[label] = counts
    return all_counts


def single_stream(cfg, device, card):
    """Phase 12: encode_stream and decode_stream of one stream; returns
    {entry point: launch counts}."""
    import dataclasses

    import torch
    from bench import make_corpus
    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.codec.decoder import decode_stream, decode_stream_pipelined
    from ulcx_torch.codec.encoder import encode_stream
    from ulcx_torch.parallel.mesh import batch_encode

    x = make_corpus(4, ONE_T, cfg.block_size)[0]  # [T, 2, N]
    audio_s = ONE_T * cfg.block_size / cfg.rate_hz
    kw = {"rate_kbps": RATE_KBPS}
    reset_launch_counts()
    out, _ = encode_stream(x, cfg, "cbr", **kw)
    torch.cuda.synchronize()
    counts = launch_counts(*PER_BLOCK)
    if counts != PER_BLOCK:  # all T blocks in one fold
        raise AssertionError(f"encode_stream launch counts {counts}, expected {PER_BLOCK}")
    check_encoded(out.size_bits[None], out.data[None], 1, ONE_T, cfg, "encode_stream")
    head, carry = encode_stream(x[: ONE_T // 2], cfg, "cbr", **kw)
    tail, _ = encode_stream(x[ONE_T // 2 :], cfg, "cbr", carry=carry, **kw)
    # as a batch of one, folded as encode_stream folds it (the same plan)
    row, _ = batch_encode(x[None], dataclasses.replace(cfg, fold_bitstream=ONE_T), "cbr", **kw)
    for name, a, h, tl, r in zip(out._fields, out, head, tail, row):
        if not torch.equal(torch.cat([h, tl]), a):
            raise AssertionError(f"encode_stream: {name} changes when the stream is coded in halves")
        if not torch.equal(r[0], a):
            raise AssertionError(f"encode_stream: {name} differs from batch_encode of one stream")
    warm = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        again, _ = encode_stream(x, cfg, "cbr", **kw)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if not torch.equal(again.data, out.data):
            raise AssertionError("encode_stream: a second run gave other bytes")
    print(f"encode_stream T={ONE_T}: identical in halves and as a folded batch of one, total "
          f"{int(out.size_bits.sum())} bits", flush=True)
    rtf_line("encode_stream", warm, audio_s, counts, card)
    few = ONE_CPU_T
    on_card, _ = encode_stream(x[:few], cfg, "cbr", **kw)
    on_cpu, _ = encode_stream(x[:few], cfg, "cbr", device="cpu", **kw)
    check_encoded(on_cpu.size_bits[None], on_cpu.data[None], 1, few, cfg, "encode_stream on the CPU")
    if not torch.equal(on_card.window_ctrl.cpu(), on_cpu.window_ctrl):
        raise AssertionError("encode_stream: window control differs between the card and the CPU")
    tot_g, tot_c = int(on_card.size_bits.sum()), int(on_cpu.size_bits.sum())
    if abs(tot_g - tot_c) > 0.01 * tot_c:
        raise AssertionError(f"encode_stream: total bits {tot_g} (cuda) vs {tot_c} (cpu)")
    print(f"encode_stream cuda vs cpu T={few}: window control equal, total bits {tot_g} vs {tot_c}, "
          f"{int((on_card.data.cpu() == on_cpu.data).all(-1).sum())}/{few} blocks byte-identical",
          flush=True)

    streams, _, win, sizes = pack_streams(type(out)(*(v[None] for v in out)))
    stream = streams[0]
    reset_launch_counts()
    pcm, bits, corrupt, (off, dcarry) = decode_stream(stream, ONE_T, win, cfg)
    torch.cuda.synchronize()
    dcounts = launch_counts(*DEC_PER_BLOCK)
    if dcounts != {k: ONE_T * v for k, v in DEC_PER_BLOCK.items()}:
        raise AssertionError(f"decode_stream launch counts {dcounts}")
    if bool(corrupt.any()):
        raise AssertionError(f"decode_stream: {int(corrupt.sum())} corrupt blocks")
    if not torch.equal(((bits + 7) // 8 * 8).cpu(), sizes[0]):
        raise AssertionError("decode_stream: bits, rounded up to bytes, differ from the sizes")
    if int(off) != int(sizes.sum()) // 8:
        raise AssertionError(f"decode_stream: ends at byte {int(off)}, not {int(sizes.sum()) // 8}")
    h = decode_stream(stream, ONE_T // 2, win, cfg)
    tl = decode_stream(stream, ONE_T // 2, win, cfg, offset=h[3][0], carry=h[3][1])
    for name, a, b_, w in zip(("pcm", "bits", "corrupt"), h, tl, (pcm, bits, corrupt)):
        if not torch.equal(torch.cat([a, b_]), w):
            raise AssertionError(f"decode_stream: {name} changes when the stream is decoded in halves")
    if not torch.equal(tl[3][0], off):
        raise AssertionError("decode_stream: the chained offset differs")
    snr = decode_snr(x[None], pcm[None].cpu().numpy())
    if not snr > MIN_SNR_DB:
        raise AssertionError(f"decode_stream: round-trip SNR {snr:.2f} dB")
    dwarm = []
    s_dev = stream.to(device)
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        decode_stream(s_dev, ONE_T, win, cfg)
        torch.cuda.synchronize()
        dwarm.append(time.perf_counter() - t0)
    print(f"decode_stream T={ONE_T} window {win} bytes: identical in halves, no corrupt block, "
          f"round-trip SNR {snr:.2f} dB", flush=True)
    rtf_line("decode_stream", dwarm, audio_s, dcounts, card)
    pcm_c, bits_c, corrupt_c, _ = decode_stream(stream, few, win, cfg, device="cpu")
    if not (torch.equal(bits[:few].cpu(), bits_c) and torch.equal(corrupt[:few].cpu(), corrupt_c)):
        raise AssertionError("decode_stream: bits or corrupt differ between the card and the CPU")
    rms = float(torch.sqrt(torch.mean((pcm[:few].cpu() - pcm_c) ** 2)))
    if rms > PCM_RMS:
        raise AssertionError(f"decode_stream: pcm differs by {rms:.3g} RMS on the CPU (limit {PCM_RMS})")
    print(f"decode_stream cuda vs cpu T={few}: bits and corrupt equal, pcm {rms:.3g} RMS apart",
          flush=True)

    reset_launch_counts()
    ppcm, pbits, pcorrupt, (poff, pcarry) = decode_stream_pipelined(stream, ONE_T, win, cfg)
    torch.cuda.synchronize()
    pcounts = launch_counts(*DEC_PER_BLOCK)
    if pcounts != {"fsm": 0, "fsm_place": ONE_T, "rng_expand": 1, "rng": 0}:
        raise AssertionError(f"decode_stream_pipelined launch counts {pcounts}")
    for name, a, b_ in (("bits", pbits, bits), ("corrupt", pcorrupt, corrupt), ("offset", poff, off),
                        ("rng", pcarry.rng, dcarry.rng),
                        ("prev_last_ss", pcarry.prev_last_ss, dcarry.prev_last_ss)):
        if not torch.equal(a, b_):
            raise AssertionError(f"decode_stream_pipelined: {name} differs from decode_stream's")
    ref = pcm.double()
    rel = float(torch.sqrt((ppcm.double() - ref).var() / ref.var()))
    lap = float((pcarry.lap - dcarry.lap).abs().max())
    if not (rel < PIPE_REL and lap <= PIPE_LAP):
        raise AssertionError(f"decode_stream_pipelined: pcm {rel:.3g} relative, lap {lap:.3g} "
                             f"from decode_stream's (limits {PIPE_REL}, {PIPE_LAP})")
    pwarm = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        decode_stream_pipelined(s_dev, ONE_T, win, cfg)
        torch.cuda.synchronize()
        pwarm.append(time.perf_counter() - t0)
    print(f"decode_stream_pipelined T={ONE_T}: bits, corrupt, offset and RNG state identical to "
          f"decode_stream's, pcm {rel:.3g} relative and lap {lap:.3g} apart", flush=True)
    rtf_line("decode_stream_pipelined", pwarm, audio_s, pcounts, card)
    print(f"single-stream decode realtime factors: decode_stream "
          f"{audio_s / sorted(dwarm)[1]:.1f}x, decode_stream_pipelined "
          f"{audio_s / sorted(pwarm)[1]:.1f}x [{card}]", flush=True)
    return {"encode_stream": counts, "decode_stream": dcounts,
            "decode_stream_pipelined": pcounts}


def past_32768(device, card):
    """Phase 13: stereo bs32768, P = 65,536. Every kernel against its
    plain version on the planes of the path's B = 256, on HUGE_COLS of
    its streams, and at a ragged B = 13; the plain versions run on the
    CPU, on copies of the same planes, since they are Python loops and
    whole-plane ops that would launch hundreds of thousands of small
    kernels on the card. Then batch_encode CBR-128 and batch_decode of
    its bytes at B = 256, T = 2 with the checks of phases 4 and 7.
    Returns ({kernel: (err, ms, plain ms, bytes)} at B = 13, the same at
    B = 256, encode counts, decode counts)."""
    import torch
    from bench import make_corpus
    from ulcx_torch.utils.config import CodecConfig

    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=HUGE_BS)
    p_tot = 2 * HUGE_BS
    x = make_corpus(HUGE_B, HUGE_T, HUGE_BS)
    cols = f"streams {HUGE_COLS[0]}-{HUGE_COLS[HUGE_PLAIN_B - 1]} and {HUGE_COLS[HUGE_PLAIN_B]}-" \
           f"{HUGE_COLS[-1]}"
    print(f"B={HUGE_B}, P={p_tot}, plain versions on the CPU on {cols}:", flush=True)
    full = kernels_vs_plain(cfg, x, device, plain_device="cpu", cols=HUGE_COLS)
    print(f"B={HUGE_PLAIN_B} (ragged), P={p_tot}, plain versions on the CPU:", flush=True)
    res = kernels_vs_plain(cfg, x[:HUGE_PLAIN_B].copy(), device, plain_device="cpu")
    torch.cuda.reset_peak_memory_stats()
    counts, warm, audio_s, encoded = main_path(cfg, x, device, per_block=HUGE_PER_BLOCK)
    enc_peak = torch.cuda.max_memory_allocated()
    rtf_line(f"bs{HUGE_BS} encode", warm, audio_s, counts, card)
    streams, offs, win, sizes = pack_streams(encoded)
    print(f"B={HUGE_B}, P={p_tot}, window {win} bytes ({2 * win - 2} tokens), plain versions on "
          f"the CPU on {cols}:", flush=True)
    full.update(decode_kernels_vs_plain(cfg, streams, offs, win, device, blocks=(0,),
                                        plain_device="cpu", cols=HUGE_COLS))
    print(f"B={HUGE_PLAIN_B} (ragged), P={p_tot}, plain versions on the CPU:", flush=True)
    res.update(decode_kernels_vs_plain(cfg, streams[:HUGE_PLAIN_B], offs[:HUGE_PLAIN_B], win,
                                       device, blocks=(0, HUGE_T - 1), plain_device="cpu"))
    torch.cuda.reset_peak_memory_stats()
    dcounts, dwarm, audio_s, _, _ = decode_main_path(cfg, x, streams, win, sizes, device)
    dec_peak = torch.cuda.max_memory_allocated()
    rtf_line(f"bs{HUGE_BS} decode", dwarm, audio_s, dcounts, card)
    print(f"P={p_tot}, B={HUGE_B}: peak memory encode {enc_peak / 2**30:.2f} GiB "
          f"({enc_peak / HUGE_B / 2**20:.1f} MiB a stream), decode {dec_peak / 2**30:.2f} GiB "
          f"[{card}]", flush=True)
    print(f"P={p_tot} kernel ms at B={HUGE_B}: "
          + ", ".join(f"{k} {v[1]:.4f}" for k, v in full.items()) + f" [{card}]", flush=True)
    return res, full, counts, dcounts


def rate_paths(device, card):
    """Phase 14: rate_search="bisect" and use_pallas="off" at stereo
    bs256, B = 13, T = 2. Returns {path: launch counts}."""
    import dataclasses

    import torch
    from bench import make_corpus
    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.bitstream import fast_encode as fe
    from ulcx_torch.codec.encoder import cbr_bit_budget, max_block_bytes
    from ulcx_torch.parallel.mesh import batch_decode, batch_encode
    from ulcx_torch.utils.config import CodecConfig

    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=RATE_BS)
    bcfg = dataclasses.replace(cfg, rate_search="bisect")
    x = make_corpus(RATE_B, RATE_T, RATE_BS)
    kw = {"rate_kbps": RATE_KBPS}

    reset_launch_counts()
    bis, _ = batch_encode(x, bcfg, "cbr", **kw)
    torch.cuda.synchronize()
    bcounts = launch_counts(*PER_BLOCK)
    want = {k: RATE_T * v for k, v in BISECT_PER_BLOCK.items()}
    if bcounts != want:
        raise AssertionError(f"bisect launch counts {bcounts}, expected {want}")
    check_encoded(bis.size_bits, bis.data, RATE_B, RATE_T, cfg, "bisect")
    # the same walk inputs on the card and on the CPU: identical counts and bytes
    blk, _ = analyze(x[:, :1].copy(), cfg, device)
    fb = fe.prepare_fast(blk, cfg)
    budget = cbr_bit_budget(cfg, RATE_KBPS).expand(RATE_B).to(torch.int32)
    got = fe.search_materialize_scan(fb, blk.n_nz, budget.to(device), bcfg, max_block_bytes(cfg))
    want_c = fe.search_materialize_scan(type(fb)(*(v if v is None else v.cpu() for v in fb)),
                                        blk.n_nz.cpu(), budget,
                                        bcfg, max_block_bytes(cfg))
    for name, a, b_ in zip(("count", "size", "bytes"), got, want_c):
        if not torch.equal(a.cpu(), b_):
            raise AssertionError(f"bisect: {name} differs between the card and the CPU")
    cpu_out, _ = batch_encode(x, bcfg, "cbr", device="cpu", **kw)
    tot_g, tot_c = int(bis.size_bits.sum()), int(cpu_out.size_bits.sum())
    if not torch.equal(bis.window_ctrl.cpu(), cpu_out.window_ctrl) or abs(tot_g - tot_c) > 0.01 * tot_c:
        raise AssertionError(f"bisect: window control or total bits ({tot_g} vs {tot_c}) differ "
                             "between the card and the CPU")
    lad, _ = batch_encode(x, cfg, "cbr", **kw)
    print(f"bisect B={RATE_B} T={RATE_T}: launches {bcounts}; from the same walk inputs count, size "
          f"and bytes identical on the card and the CPU; end to end {tot_g} bits (CPU {tot_c}), "
          f"the ladder {int(lad.size_bits.sum())}", flush=True)
    secs = {}
    for label, c in (("ladder", cfg), ("bisect", bcfg), ("ladder", cfg), ("bisect", bcfg)):
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            batch_encode(x, c, "cbr", **kw)
            torch.cuda.synchronize()
            secs.setdefault(label, []).append(time.perf_counter() - t0)
    med = {k: sorted(v)[len(v) // 2] for k, v in secs.items()}
    print(f"encode B={RATE_B} T={RATE_T} bs{RATE_BS}, median of {2 * WARM_RUNS} warm runs: ladder "
          f"{med['ladder'] * 1e3:.2f} ms, bisect {med['bisect'] * 1e3:.2f} ms "
          f"({med['bisect'] / med['ladder']:.2f}x) [{card}]", flush=True)

    streams, _, win, _ = pack_streams(lad)
    ref_dec = batch_decode(streams, RATE_T, win, cfg)
    out = {"bisect": bcounts}
    for label, c in (("off", dataclasses.replace(cfg, use_pallas="off")),
                     ("off, bisect", dataclasses.replace(bcfg, use_pallas="off"))):
        reset_launch_counts()
        enc, _ = batch_encode(x, c, "cbr", **kw)
        dec = batch_decode(streams, RATE_T, win, c) if label == "off" else None
        torch.cuda.synchronize()
        launched = launch_counts()
        if any(launched.values()):
            raise AssertionError(f"use_pallas={label}: kernels launched {launched}")
        ref = lad if label == "off" else bis
        for name in ("size_bits", "data", "window_ctrl"):
            if not torch.equal(getattr(enc, name), getattr(ref, name)):
                raise AssertionError(f"use_pallas={label}: {name} differs from the kernels'")
        # bits and corrupt flags exact; PCM through the plain path's GEMMs, not the kernel's FFT
        if dec is not None and not (
                all(torch.equal(a, b_) for a, b_ in zip(dec[1:], ref_dec[1:]))
                and float(torch.sqrt(torch.mean((dec[0] - ref_dec[0]) ** 2))) <= PCM_RMS):
            raise AssertionError("use_pallas=off: decode differs from the kernels'")
        print(f"use_pallas={label} on the card: no kernel launched, bytes identical to the kernels'"
              + ("; decoded bits and corrupt identical, pcm within PCM_RMS" if dec is not None
                 else ""), flush=True)
        out[f"use_pallas={label}"] = launched
    return out


def gap_window(cfg, x, device, card, seg_rtf, seg_bits):
    """Phase 15: noise_run_window="gap" at phase 4's shape (B = 512,
    T = 8): launches T x GAP_PER_BLOCK, every block within its budget,
    the streams decode clean; on a block step's planes the gap p3 walks
    timed beside the segment window's, and on GAP_PLAIN_B of its streams
    equal on the card and on the CPU wherever the two devices' exp gives
    the same noise code. Returns the launch counts."""
    import dataclasses

    import torch

    from ulcx_torch.bitstream import encode_kernels as ek
    from ulcx_torch.bitstream import fast_encode as fe
    from ulcx_torch.codec.encoder import max_block_bytes

    gcfg = dataclasses.replace(cfg, noise_run_window="gap")
    torch.cuda.reset_peak_memory_stats()
    counts, warm, audio_s, out = main_path(gcfg, x, device, per_block=GAP_PER_BLOCK)
    peak = torch.cuda.max_memory_allocated()
    gap_rtf = rtf_line("gap encode", warm, audio_s, counts, card)
    streams, _, win, sizes = pack_streams(out)
    dcounts, _, _, snr, _ = decode_main_path(gcfg, x, streams, win, sizes, device)
    gap_bits = int(out.size_bits.sum())
    print(f"gap vs segment, B={x.shape[0]} T={x.shape[1]}, one process: encode realtime factor "
          f"{gap_rtf:.1f}x vs {seg_rtf:.1f}x ({seg_rtf / gap_rtf:.2f}x slower), total "
          f"{gap_bits} vs {seg_bits} bits ({(gap_bits - seg_bits) / seg_bits:+.4%}), round-trip "
          f"SNR {snr:.2f} dB, peak memory {peak / 2**30:.2f} GiB [{card}]", flush=True)

    # one block step's planes at the path's B: the gap p3 walks timed beside
    # the segment window's plain walks and kernels, and held to the CPU on
    # GAP_PLAIN_B streams
    blk, _ = analyze(x[:, :2].copy(), gcfg, device)
    pl = fe.make_planes(fe.prepare_fast(blk, gcfg))
    b = blk.n_nz.shape[0]
    steps = torch.arange(1, fe.N_CAND + 1, dtype=torch.int32, device=device)
    nn = torch.minimum(((blk.n_nz[:, None] + 7) // 8) * steps, blk.n_nz[:, None]).to(torch.int32)
    state = fe._state(pl, nn, fe.walks(gcfg))
    n_words = max_block_bytes(gcfg) // 4
    size_args = (pl.thr, pl.aux, state)
    mat_args = (pl.coef, pl.ampn, pl.hfamp, pl.hfmeta, pl.aux, state, pl.hdr, n_words)
    walks = {"p3_size": (ek.p3_size_gap_plain, size_args + pl.gap, ek.p3_size_plain, ek.p3_size,
                         size_args),
             "p3_materialize": (ek.p3_materialize_gap_plain, mat_args + pl.gap,
                                ek.p3_materialize_plain, ek.p3_materialize, mat_args)}
    cols = tuple(range(GAP_PLAIN_B))
    pos = torch.arange(state.shape[0], device=device)[:, None, None]
    z_r = torch.clamp((state & ek.NCP_MAX) - pos, 0, ek.SENT).to(torch.int32)
    q_in = [take_cols(v, b, cols) for v in (z_r, (state >> 24) & 0x1F, *pl.gap)]
    nq = [ek._gap_noise_q(*(v.to(d) for v in q_in)) for d in (device, "cpu")]
    ties = (nq[0].cpu() != nq[1]).any(0)  # [8, 8] columns whose noise codes differ
    for name, (gap_fn, gap_args, seg_fn, kernel, seg_args) in walks.items():
        ms = {}
        for label, fn, args in (("gap plain", gap_fn, gap_args), ("segment plain", seg_fn, seg_args),
                                ("segment kernel", kernel, seg_args)):
            fn(*args)
            out, ms[label] = timed(fn, args, WARM_RUNS)
            if label == "gap plain":
                on_card = out
        on_cpu = gap_fn(*(take_cols(a, b, cols).cpu() if isinstance(a, torch.Tensor) else a
                          for a in gap_args))
        on_card = on_card if isinstance(on_card, tuple) else (on_card,)
        on_cpu = on_cpu if isinstance(on_cpu, tuple) else (on_cpu,)
        for g, w in zip(on_card, on_cpu):
            same = (take_cols(g, b, cols).cpu() == w).reshape(w.shape[0], w.shape[1], -1).all(-1)
            if not bool((same | ties).all()):
                raise AssertionError(f"{name} gap: card and CPU differ where their noise codes agree")
        entry = {label: plain_entry_bytes(fn, args, state.numel())
                 for label, fn, args in (("gap", gap_fn, gap_args), ("segment", seg_fn, seg_args))}
        print(f"{name} B={b} P={state.shape[0]}, ms on the card: gap plain {ms['gap plain']:.2f}, "
              f"segment plain {ms['segment plain']:.2f}, segment kernel {ms['segment kernel']:.4f}; "
              f"peak bytes a (position, stream, candidate) in one chunk: gap {entry['gap']:.1f}, "
              f"segment {entry['segment']:.1f} [{card}]; gap on streams 0-{GAP_PLAIN_B - 1} equal "
              f"on the card and the CPU in every (stream, candidate) but {int(ties.sum())} whose "
              f"noise codes the devices' exp put apart", flush=True)
    return counts


def multichannel(b, t, c, n):
    """[b, t, c, n]: c / 2 stereo corpus streams side by side per stream."""
    from bench import make_corpus

    s = make_corpus(b * c // 2, t, n)
    return s.reshape(b, c // 2, t, 2, n).transpose(0, 2, 1, 3, 4).reshape(b, t, c, n).copy()


def scan_path(device, card):
    """Phase 18: ulcx's scan path. 16 channels x bs2048 CBR-128 (P = 32768)
    at B = 13, T = 2, which takes the scan path's plan: launches T x
    SCAN_PER_BLOCK, budgets, a second run identical (main_path), count,
    size and bytes from the same walk inputs identical on the card and
    the CPU, a clean decode; its total beside the kernel path's plan on
    the first SCAN_KERNEL_B streams. Then encode_block over ONE_BLOCKS
    flagship blocks against encode_stream of them (T = 12, the scan
    path's plan too), and decode_block against decode_stream of their
    bytes, launching the record-mode FSM once a block. Returns {path:
    launch counts}."""
    import torch
    from bench import make_corpus
    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.analysis.block import map_leaves
    from ulcx_torch.bitstream import fast_encode as fe
    from ulcx_torch.codec.decoder import DecoderCarry, decode_block, decode_stream
    from ulcx_torch.codec.encoder import (cbr_bit_budget, encode_block, encode_stream,
                                          init_carry_batched, max_block_bytes)
    from ulcx_torch.parallel.mesh import batch_encode
    from ulcx_torch.utils.config import CodecConfig

    cfg = CodecConfig(rate_hz=44100, n_chan=SCAN_CHAN, block_size=SCAN_BS)
    x = multichannel(SCAN_B, SCAN_T, SCAN_CHAN, SCAN_BS)
    print(f"{SCAN_CHAN} ch x bs{SCAN_BS} (P = {SCAN_CHAN * SCAN_BS}), B={SCAN_B}, T={SCAN_T}, "
          "the scan path's plan:", flush=True)
    counts, warm, audio_s, out = main_path(cfg, x, device, per_block=SCAN_PER_BLOCK)
    rtf_line(f"{SCAN_CHAN} ch bs{SCAN_BS} scan-plan encode", warm, audio_s, counts, card)
    blk, _ = analyze(x[:, :1].copy(), cfg, device)
    fb = fe.prepare_fast(blk, cfg)
    budget = cbr_bit_budget(cfg, RATE_KBPS).expand(SCAN_B).to(torch.int32)
    t0 = time.perf_counter()
    want_c = fe.search_materialize_scan(type(fb)(*(v if v is None else v.cpu() for v in fb)),
                                        blk.n_nz.cpu(), budget, cfg, max_block_bytes(cfg))
    cpu_s = time.perf_counter() - t0
    got = fe.search_materialize_scan(fb, blk.n_nz, budget.to(device), cfg, max_block_bytes(cfg))
    for name, a, b_ in zip(("count", "size", "bytes"), got, want_c):
        if not torch.equal(a.cpu(), b_):
            raise AssertionError(f"scan path: {name} differs between the card and the CPU")
    print(f"scan path: from the same walk inputs count, size and bytes identical on the card and "
          f"the CPU (CPU {cpu_s:.1f} s)", flush=True)
    streams, _, win, sizes = pack_streams(out)
    dcounts, _, _, snr, (pcm, _, _) = decode_main_path(cfg, x, streams, win, sizes, device,
                                                       min_snr=None)

    reset_launch_counts()
    kern, _ = batch_encode(x[:SCAN_KERNEL_B], cfg, "cbr", rate_kbps=RATE_KBPS)
    torch.cuda.synchronize()
    kcounts = launch_counts(*PER_BLOCK)
    if kcounts != {k: SCAN_T * v for k, v in PER_BLOCK.items()}:
        raise AssertionError(f"kernel plan launch counts {kcounts}")
    check_encoded(kern.size_bits, kern.data, SCAN_KERNEL_B, SCAN_T, cfg, "kernel plan")
    k_streams, _, k_win, k_sizes = pack_streams(kern)
    _, _, _, k_snr, _ = decode_main_path(cfg, x[:SCAN_KERNEL_B], k_streams, k_win, k_sizes, device,
                                         min_snr=None)
    s_snr = decode_snr(x[:SCAN_KERNEL_B], pcm[:SCAN_KERNEL_B].cpu().numpy())
    if not s_snr >= k_snr - 0.3:
        raise AssertionError(f"scan plan SNR {s_snr:.2f} dB vs the kernel plan's {k_snr:.2f} dB")
    scan8 = out.size_bits[:SCAN_KERNEL_B]
    tot_s, tot_k = int(scan8.sum()), int(kern.size_bits.sum())
    more = float((scan8 > kern.size_bits).float().mean())
    print(f"first {SCAN_KERNEL_B} streams: scan plan {tot_s} bits vs kernel plan {tot_k} "
          f"({(tot_s - tot_k) / tot_k:+.4%}); the scan plan codes more in {more:.1%} of blocks, "
          f"less in {float((scan8 < kern.size_bits).float().mean()):.1%}; round-trip SNR "
          f"{s_snr:.2f} vs {k_snr:.2f} dB (all {SCAN_B}: {snr:.2f} dB) [{card}]", flush=True)

    # one flagship stream, block by block on ulcx's single-block forms
    fcfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=BS)
    xs = make_corpus(1, ONE_BLOCKS, BS)[0]
    kw = {"rate_kbps": RATE_KBPS}
    reset_launch_counts()
    whole, _ = encode_stream(xs, fcfg, "cbr", **kw)
    torch.cuda.synchronize()
    s_counts = launch_counts(*PER_BLOCK)
    if s_counts != ONE_BLOCK_PER_BLOCK:
        raise AssertionError(f"encode_stream T={ONE_BLOCKS} launch counts {s_counts}")
    carry = map_leaves(lambda v: v[0], init_carry_batched(fcfg, 1, device))
    blocks = torch.from_numpy(xs).to(device)
    reset_launch_counts()
    steps = []
    for j in range(ONE_BLOCKS):
        carry, enc = encode_block(carry, blocks[j], fcfg, "cbr", **kw)
        steps.append(enc)
    torch.cuda.synchronize()
    b_counts = launch_counts(*PER_BLOCK)
    if b_counts != {k: ONE_BLOCKS * v for k, v in ONE_BLOCK_PER_BLOCK.items()}:
        raise AssertionError(f"encode_block launch counts {b_counts}")
    for name in whole._fields:
        if not torch.equal(torch.stack([getattr(e, name) for e in steps]), getattr(whole, name)):
            raise AssertionError(f"encode_block: {name} differs from encode_stream's")
    print(f"encode_block x {ONE_BLOCKS}: identical to encode_stream T={ONE_BLOCKS} (both the scan "
          f"path's plan), launches {b_counts}", flush=True)

    one_streams, _, one_win, one_sizes = pack_streams(type(whole)(*(v[None] for v in whole)))
    stream = one_streams[0].to(device)
    pcm, bits, corrupt, (_, dcarry) = decode_stream(stream, ONE_BLOCKS, one_win, fcfg)
    dcarry_b = DecoderCarry.init(fcfg, 1, device)
    c = DecoderCarry(*(v[0] for v in dcarry_b))
    reset_launch_counts()
    off, outs = 0, []
    for j in range(ONE_BLOCKS):
        p, c, nbits, bad = decode_block(stream[off: off + one_win], c, fcfg)
        outs.append((p, nbits, bad))
        off += (int(nbits) + 7) // 8
    torch.cuda.synchronize()
    d_counts = launch_counts(*DEC_PER_BLOCK)
    if d_counts != {k: ONE_BLOCKS * v for k, v in DEC_BLOCK_PER_BLOCK.items()}:
        raise AssertionError(f"decode_block launch counts {d_counts}")
    for name, got_, want_ in (("pcm", torch.stack([o[0] for o in outs]), pcm),
                              ("bits", torch.stack([o[1] for o in outs]), bits),
                              ("corrupt", torch.stack([o[2] for o in outs]), corrupt)):
        if not torch.equal(got_, want_):
            raise AssertionError(f"decode_block: {name} differs from decode_stream's")
    if not all(torch.equal(a, b_) for a, b_ in zip(c, dcarry)) or bool(corrupt.any()):
        raise AssertionError("decode_block: the carry differs from decode_stream's, or a block is corrupt")
    if not torch.equal(((bits + 7) // 8 * 8).cpu(), one_sizes[0]):
        raise AssertionError("decode_block: bits, rounded up to bytes, differ from the sizes")
    print(f"decode_block x {ONE_BLOCKS}: pcm, bits, corrupt flags and carry identical to "
          f"decode_stream, launches {d_counts}", flush=True)
    return {"scan path": counts, "scan path decode": dcounts, "encode_block": b_counts,
            "decode_block": d_counts}


def public_names(cfg, x, device, card):
    """Phase 19: rate_search_fast against the fused search and the plain
    walks on the card, both searches timed; the per-frame MDCT/MDST and
    the scanned ema against the CPU. Returns {"rate_search_fast": its
    launches of p1, p2 and p3 size at B = MAIN_B}."""
    import dataclasses

    import torch

    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.bitstream import fast_encode as fe
    from ulcx_torch.codec.encoder import cbr_bit_budget, max_block_bytes
    from ulcx_torch.ops import mdct, scanutil

    off = dataclasses.replace(cfg, use_pallas="off")
    counts = {}
    for b in (MAIN_B, RAGGED_B):
        blk, _ = analyze(x[:b, :1].copy(), cfg, device)  # the first block step
        fb = fe.prepare_fast(blk, cfg)
        budget = cbr_bit_budget(cfg, RATE_KBPS).expand(b).to(device=device, dtype=torch.int32)
        args = (fb, blk.n_nz, budget, cfg)
        reset_launch_counts()
        n = fe.rate_search_fast(*args)
        torch.cuda.synchronize()
        counts[b] = launch_counts(*PER_BLOCK)
        if counts[b] != RATE_SEARCH_FAST:
            raise AssertionError(f"rate_search_fast B={b}: launches {counts[b]}, "
                                 f"expected {RATE_SEARCH_FAST}")
        fused = fe.search_materialize_fast(*args, max_block_bytes(cfg))[0]
        plain = fe.rate_search_fast(fb, blk.n_nz, budget, off)
        if not (torch.equal(n, fused) and torch.equal(n, plain)):
            raise AssertionError(f"rate_search_fast B={b}: the count differs from the fused "
                                 f"search's in {int((n != fused).sum())} streams, from the plain "
                                 f"walks' in {int((n != plain).sum())}")
        ms = {}
        for label, fn, a in (("rate_search_fast", fe.rate_search_fast, args),
                             ("search_materialize_fast", fe.search_materialize_fast,
                              (*args, max_block_bytes(cfg)))):
            ms[label] = sorted(timed(fn, a, 1)[1] for _ in range(NAMES_TIMED))[NAMES_TIMED // 2]
        print(f"rate_search_fast B={b} P={cfg.n_chan * cfg.block_size}: launches {counts[b]}; the "
              f"count equals search_materialize_fast's and the plain walks' on the card in every "
              f"stream (mean {float(n.float().mean()):.1f}); median of {NAMES_TIMED} warm calls "
              f"{ms['rate_search_fast']:.3f} ms a call, search_materialize_fast "
              f"{ms['search_materialize_fast']:.3f} ms [{card}]", flush=True)

    gen = torch.Generator(device="cpu").manual_seed(19)
    for s, backends in ((2048, ("matmul",)), (32768, ("fact", "fft"))):
        rows = FRAME_ROWS[s]
        frames = torch.randn(rows, 2 * s, generator=gen)
        shifts = torch.randint(0, s.bit_length(), (2, rows), generator=gen)
        o_left, o_right = torch.where(shifts == 0, 0, 1 << shifts)  # 0 or a power of two <= S
        for backend in backends:
            want = (*mdct.mdct_mdst_frame(frames, o_left, o_right, backend),
                    mdct.mdct_frame(frames, o_left, o_right, backend))
            got = (*mdct.mdct_mdst_frame(frames.to(device), o_left.to(device), o_right.to(device),
                                         backend),
                   mdct.mdct_frame(frames.to(device), o_left.to(device), o_right.to(device), backend))
            rel = max(float((g.cpu() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
            if not rel <= FRAME_TOL:
                raise AssertionError(f"mdct_mdst_frame S={s} {backend}: {rel:.3g} of the largest "
                                     f"magnitude from the CPU's (limit {FRAME_TOL})")
            print(f"mdct_mdst_frame, mdct_frame S={s} {backend} x {rows} frames: within {rel:.2e} "
                  f"of the largest magnitude of the CPU's", flush=True)
    v = torch.rand(MAIN_B, 2 * BS, generator=gen) ** 2
    init = torch.rand(MAIN_B, generator=gen)
    rate = float(torch.tensor(-115.0 / 44100.0).exp())
    for reverse in (False, True):
        want = scanutil.ema(v, rate, init, reverse=reverse)
        got = scanutil.ema(v.to(device), rate, init.to(device), reverse=reverse)
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        if not rel <= EMA_TOL:
            raise AssertionError(f"ema reverse={reverse}: {rel:.3g} of the largest magnitude "
                                 f"from the CPU's (limit {EMA_TOL})")
        print(f"ema [{MAIN_B}, {2 * BS}] reverse={reverse}: within {rel:.2e} of the largest "
              f"magnitude of the CPU's", flush=True)
    return {"rate_search_fast": {k: c for k, c in counts[MAIN_B].items() if k != "p3_materialize"}}


def plain_entry_bytes(fn, args, entries):
    """Peak device bytes above the inputs a (position, stream, candidate)
    of one plain walk run on the whole batch as one chunk (what
    ``encode_kernels.PLAIN_ENTRY_BYTES`` sizes its chunks by)."""
    import torch

    from ulcx_torch.bitstream import encode_kernels as ek

    limit = ek.PLAIN_CHUNK_BYTES
    ek.PLAIN_CHUNK_BYTES = 1 << 62
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(*args)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / entries
    finally:
        ek.PLAIN_CHUNK_BYTES = limit


def write_wav(path, blocks, bits=16):
    """[T, C, N] float blocks -> a 44.1 kHz WAV (PCM16 or FLOAT32)."""
    from ulcx_torch.io.wavio import WavWriter

    w = WavWriter(path, 44100, blocks.shape[1], bits, 3 if bits == 32 else 1)
    w.write_frames(blocks.transpose(0, 2, 1).reshape(-1))
    w.close()


def read_wav(path):
    """(frames [n, C] float32, WavInfo)."""
    from ulcx_torch.io.wavio import WavReader

    r = WavReader(path)
    try:
        return r.read_frames(r.info.n_samples).reshape(-1, r.info.n_chan), r.info
    finally:
        r.close()


def run_tool(tool, *args):
    """Start ``python -m ulcx_torch.tools.<tool> args`` from the repo root."""
    env = {**os.environ, "PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.Popen([sys.executable, "-m", f"ulcx_torch.tools.{tool}", *args], cwd=HERE,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(procs, timeout=600):
    """{label: (exit code, stdout)} of started tools, each waited for."""
    res = {}
    for label, proc in procs.items():
        out, err = proc.communicate(timeout=timeout)
        res[label] = (proc.returncode, out + err)
    return res


def tools(device, card):
    """Phase 16: the CLI trio, by subprocess and in process, on
    TOOL_SECONDS-second stereo PCM16 WAVs of the corpus; the five error
    paths; -profile:; a checkpoint on the card."""
    import shutil
    import tempfile

    import numpy as np
    from bench import make_corpus
    from ulcx_torch._build import launch_counts, reset_launch_counts
    from ulcx_torch.codec.decoder import decode_stream
    from ulcx_torch.container import HEADER_SIZE, UlcHeader
    from ulcx_torch.io import native
    from ulcx_torch.io.wavio import float_to_raw
    from ulcx_torch.tools.batch_tool import main as batch_main
    from ulcx_torch.tools.decode_tool import main as decode_main
    from ulcx_torch.tools.encode_tool import main as encode_main
    from ulcx_torch.utils.config import CodecConfig

    print(f"native I/O library {'loaded' if native.available() else 'not loaded: NumPy path'}",
          flush=True)
    n = BS
    t = -(-TOOL_SECONDS * 44100 // n)
    corpus = make_corpus(TOOL_FILES, t, n)  # [F, T, 2, N]
    tmp = tempfile.mkdtemp(prefix="ulcx_tools_")
    try:
        wavs = [os.path.join(tmp, f"in{i}.wav") for i in range(TOOL_FILES)]
        for path, blocks in zip(wavs, corpus):
            write_wav(path, blocks)
        x, info = read_wav(wavs[0])  # the PCM16 values the tools read
        audio_s = info.n_samples / 44100
        n_blocks = -(-info.n_samples // n) + 2
        ulc = {m: os.path.join(tmp, f"{m}.ulc") for m in ("cbr", "vbr", "abr")}
        rates = {"cbr": "128", "vbr": "-55", "abr": "128,0.5"}
        t0 = time.perf_counter()
        res = finish({m: run_tool("encode_tool", wavs[0], ulc[m], rates[m], f"-blocksize:{n}")
                      for m in ulc})
        print(f"encode_tool x3 (CBR-128, VBR -55, ABR 128,0.5) side by side: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for m, (rc, out) in res.items():
            if rc != 0 or "Total size = " not in out or "Avg complexity = " not in out:
                raise AssertionError(f"encode_tool {m}: exit {rc}\n{out[-2000:]}")
            hdr = UlcHeader.unpack(open(ulc[m], "rb").read())
            if (hdr.block_size, hdr.n_chan, hdr.rate_hz, hdr.n_blocks) != (n, 2, 44100, n_blocks):
                raise AssertionError(f"encode_tool {m}: header {hdr}")
            if m == "cbr" and hdr.max_block_size * 8 > CBR_BUDGET:
                raise AssertionError(f"encode_tool cbr: a block of {hdr.max_block_size} bytes")
            print(f"encode_tool {m}: {out.strip().splitlines()[-4]}; header {hdr}", flush=True)

        # the five error paths, and the decodes, side by side
        garbage, truncated = os.path.join(tmp, "g.ulc"), os.path.join(tmp, "t.ulc")
        with open(garbage, "wb") as f:
            f.write(b"garbage" * 10)
        data = open(ulc["cbr"], "rb").read()
        with open(truncated, "wb") as f:
            f.write(data[: HEADER_SIZE + (len(data) - HEADER_SIZE) // 2])
        z = os.path.join(tmp, "z")
        errors = {
            "rate 0": (("encode_tool", wavs[0], z, "0"), 1, "ERROR: Invalid coding rate"),
            "block size": (("encode_tool", wavs[0], z, "128", "-blocksize:1000"), 1,
                           "ERROR: Unsupported block size"),
            "format": (("decode_tool", ulc["cbr"], z, "-format:MP3"), 255,
                       "ERROR: Ignoring invalid output format"),
            "not a container": (("decode_tool", garbage, z), 255,
                                "ERROR: Input file is not a valid ULC container"),
            "truncated": (("decode_tool", truncated, z), 255, "ERROR: Corrupted stream."),
        }
        out_wav = {f: os.path.join(tmp, f"cbr.{f}.wav") for f in ("PCM16", "FLOAT32")}
        procs = {k: run_tool(*v[0]) for k, v in errors.items()}
        procs.update({f: run_tool("decode_tool", ulc["cbr"], p, f"-format:{f}")
                      for f, p in out_wav.items()})
        res = finish(procs)
        for k, (args, rc, msg) in errors.items():
            if res[k][0] != rc or msg not in res[k][1]:
                raise AssertionError(f"error path {k}: exit {res[k][0]}, expected {rc} and "
                                     f"{msg!r}\n{res[k][1][-2000:]}")
        print(f"error paths: {', '.join(f'{k} -> exit {rc}' for k, (_, rc, _) in errors.items())}, "
              f"each with ulcx's message", flush=True)
        for f in out_wav:
            if res[f][0] != 0 or "Ok" not in res[f][1]:
                raise AssertionError(f"decode_tool {f}: exit {res[f][0]}\n{res[f][1][-2000:]}")

        # the tools' PCM against decode_stream of the same bytes
        hdr = UlcHeader.unpack(data)
        cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=n)
        win = -(-max(hdr.max_block_size, 16) // 64) * 64
        stream = np.concatenate([np.frombuffer(data[HEADER_SIZE:], np.uint8),
                                 np.zeros(win + 64, np.uint8)])
        pcm, _, corrupt, _ = decode_stream(stream, n_blocks, win, cfg)
        if bool(corrupt.any()):
            raise AssertionError("decode_stream: the encode tool's stream decodes corrupt")
        ref = pcm.transpose(1, 2).reshape(-1, 2).cpu().numpy().astype(np.float64)
        got32, i32 = read_wav(out_wav["FLOAT32"])
        got16, i16 = read_wav(out_wav["PCM16"])
        if not (i32.n_samples == i16.n_samples == n_blocks * n and i32.bits == 32 and i16.bits == 16):
            raise AssertionError(f"decoded WAVs {i32}, {i16}")
        rel = float(np.sqrt(np.var(got32 - ref) / np.var(ref)))
        lsb = int(np.abs(got16.astype(np.float64) * 32768
                         - float_to_raw(ref.astype(np.float32), 16, 1).view("<i2").reshape(-1, 2)).max())
        if not (rel < PIPE_REL and lsb <= 1):
            raise AssertionError(f"decode_tool vs decode_stream: FLOAT32 {rel:.3g} relative, PCM16 "
                                 f"{lsb} LSB (limits {PIPE_REL}, 1)")
        mid = slice(n, (n_blocks - 3) * n)  # decoded block j is input block j - 1
        err = got32[n:][: x.shape[0]][mid] - x[mid]
        snr = 10 * np.log10((x[mid].astype(np.float64) ** 2).sum() / (err.astype(np.float64) ** 2).sum())
        if not snr > MIN_SNR_DB:
            raise AssertionError(f"decode_tool: SNR {snr:.2f} dB over the middle blocks")
        print(f"decode_tool PCM16 and FLOAT32: {n_blocks} blocks; FLOAT32 {rel:.3g} relative from "
              f"decode_stream's PCM, PCM16 within {lsb} LSB of it converted; SNR over the middle "
              f"blocks {snr:.2f} dB", flush=True)

        # in process: each tool timed warm (the second of two runs) on the card
        secs = {}
        for label, fn, argv in (
                ("encode_tool CBR-128", encode_main, ["e", wavs[0], ulc["cbr"] + ".2", "128"]),
                ("decode_tool FLOAT32", decode_main, ["d", ulc["cbr"], z + ".wav", "-format:FLOAT32"]),
                ("decode_tool PCM16", decode_main, ["d", ulc["cbr"], z + ".wav"])):
            for _ in range(2):
                reset_launch_counts()
                t0 = time.perf_counter()
                if fn(argv, device=device) != 0:
                    raise AssertionError(f"{label}: in process, a non-zero exit")
                secs[label] = time.perf_counter() - t0
            launched = {k: v for k, v in launch_counts().items() if v}
            print(f"\n{label} in process: realtime factor {audio_s / secs[label]:.1f}x ({audio_s:.1f} s "
                  f"of audio in {secs[label]:.2f} s, the second of two runs), launches {launched} "
                  f"[{card}]", flush=True)
        if open(ulc["cbr"] + ".2", "rb").read() != data:
            raise AssertionError("encode_tool: in process and by subprocess, other bytes")

        # the batch tool over TOOL_FILES files
        out_dir = os.path.join(tmp, "batch")
        reset_launch_counts()
        t0 = time.perf_counter()
        if batch_main(["b", out_dir, "128", *wavs, f"-blocksize:{n}"], device=device) != 0:
            raise AssertionError("batch_tool: a non-zero exit")
        bsecs = time.perf_counter() - t0
        batch_counts = launch_counts(*PER_BLOCK)
        want = {k: n_blocks * v for k, v in PER_BLOCK.items()}
        if batch_counts != want:
            raise AssertionError(f"batch_tool: launch counts {batch_counts}, expected {want} "
                                 f"(the kernel path's plan, {TOOL_FILES} files padded to 8)")
        for i in range(TOOL_FILES):
            raw = open(os.path.join(out_dir, f"in{i}.ulc"), "rb").read()
            bh = UlcHeader.unpack(raw)
            bw = -(-max(bh.max_block_size, 16) // 64) * 64
            s = np.concatenate([np.frombuffer(raw[HEADER_SIZE:], np.uint8), np.zeros(bw + 64, np.uint8)])
            _, _, bad, _ = decode_stream(s, bh.n_blocks, bw, cfg)
            if bh.n_blocks != n_blocks or bh.max_block_size * 8 > CBR_BUDGET or bool(bad.any()):
                raise AssertionError(f"batch_tool: file {i}: header {bh}, corrupt {int(bad.sum())}")
        print(f"\nbatch_tool {TOOL_FILES} files padded to 8: headers and budgets kept, every file "
              f"decodes clean; launches {batch_counts} = {n_blocks} block steps x (3, 3, 2, 1), "
              f"the kernel path's plan; {TOOL_FILES * audio_s / bsecs:.1f}x realtime aggregate "
              f"({bsecs:.2f} s) [{card}]", flush=True)
        print(f"batch_tool {TOOL_FILES} files unpadded, the scan path's plan (recorded): "
              f"{SCAN_PLAN_BATCH_RTF}", flush=True)

        # -profile: on a short WAV
        short = os.path.join(tmp, "short.wav")
        write_wav(short, corpus[1, :PROFILE_BLOCKS])
        trace_dir = os.path.join(tmp, "trace")
        if encode_main(["e", short, z, "128", f"-profile:{trace_dir}"], device=device) != 0:
            raise AssertionError("encode_tool -profile: a non-zero exit")
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        body = open(traces[0], "rb").read() if len(traces) == 1 else b""
        if b"traceEvents" not in body or b"aten::" not in body:
            raise AssertionError(f"-profile: {traces} holds no trace")
        kernels = [k for k in ("p1_kernel", "p2_kernel", "p3_kernel") if k.encode() in body]
        print(f"\n-profile: {os.path.basename(traces[0])}, {len(body)} bytes; the card's walk "
              f"kernels in it: {kernels or 'none (no device activity traced)'}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    checkpoint_resume(cfg, corpus[-1, :CKPT_T], device)
    return {"batch_tool": batch_counts}


def checkpoint_resume(cfg, xs, device):
    """Phase 16's checkpoint: encode_stream of the first half of xs
    [T, 2, N], its carry through save_carry and load_carry (a file on
    disk), the second half from the loaded carry: one call's bytes."""
    import shutil
    import tempfile

    import torch
    from ulcx_torch.codec.encoder import _map, encode_stream
    from ulcx_torch.utils.checkpoint import _leaves, load_carry, save_carry

    half = xs.shape[0] // 2
    kw = {"rate_kbps": RATE_KBPS}
    full, _ = encode_stream(xs, cfg, "cbr", device=device, **kw)
    head, carry = encode_stream(xs[:half], cfg, "cbr", device=device, **kw)
    path = os.path.join(tempfile.mkdtemp(prefix="ulcx_ckpt_"), "carry.npz")
    try:
        save_carry(path, carry)
        loaded = load_carry(path, _map(torch.zeros_like, carry))
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    if not all(a.device == b_.device and torch.equal(a, b_)
               for (_, a), (_, b_) in zip(_leaves(loaded), _leaves(carry))):
        raise AssertionError("checkpoint: the loaded carry differs from the saved one")
    tail, _ = encode_stream(xs[half:], cfg, "cbr", carry=loaded, device=device, **kw)
    for name in ("size_bits", "data"):
        if not torch.equal(torch.cat([getattr(head, name), getattr(tail, name)]), getattr(full, name)):
            raise AssertionError(f"checkpoint: resumed {name} differ from one call's")
    print(f"checkpoint on the {device}: {half} + {xs.shape[0] - half} blocks through save_carry / "
          f"load_carry give one call's bytes", flush=True)

def mesh_of_one(cfg, x, encoded, decoded, streams, win, sizes, card):
    """Phase 17 (a): ``data_mesh()`` in this process, a world of one on
    the card over NCCL, through phase 4's and 7's checks; its blocks and
    decode identical to theirs. Returns (encode, decode launch counts)."""
    import torch

    from ulcx_torch.parallel.mesh import data_mesh

    mesh = data_mesh()
    try:
        print(f"mesh of one: {torch.distributed.get_backend(mesh.group)} on {mesh.device}",
              flush=True)
        counts, warm, audio_s, out = main_path(cfg, x, "cuda", mesh=mesh)
        if not all(torch.equal(u, v) for u, v in zip(out, encoded)):
            raise AssertionError("the mesh of one encodes other blocks than phase 4")
        rtf_line("mesh of one encode", warm, audio_s, counts, card)
        dcounts, dwarm, audio_s, _, dec = decode_main_path(cfg, x, streams, win, sizes, "cuda",
                                                           mesh=mesh)
        if not all(torch.equal(u, v) for u, v in zip(dec, decoded)):
            raise AssertionError("the mesh of one decodes other pcm, bits or flags than phase 7")
        rtf_line("mesh of one decode", dwarm, audio_s, dcounts, card)
    finally:
        mesh.close()
    print("mesh of one: blocks, sizes, pcm, bits and corrupt flags identical to phases 4 and 7",
          flush=True)
    return counts, dcounts


def mesh_ranks(cfg, x, encoded, ref_snr, enc_rtf, dec_rtf, card):
    """Phase 17 (b): ``python -m ulcx_torch.graft_entry mesh`` under
    torchrun at phase 4's shape: NCCL over a card each where two or more
    are visible (at most MESH_MAX_RANKS), else two ranks sharing card 0
    over gloo. Each rank's shard equals the no-mesh call on its rows; the
    whole holds phase 11's card bounds against phase 4 (a rank's
    analysis GEMMs sum its B/n rows in another order than B rows); the
    all-reduced total is the float32 sum of the shards; every block
    decodes clean. Returns (ranks, cards, rank 0's launch counts,
    {"encode": aggregate realtime factor, "decode": ...})."""
    import tempfile

    import numpy as np
    import torch

    from ulcx_torch import graft_entry

    count = torch.cuda.device_count()
    n = min(count, MESH_MAX_RANKS) if count >= 2 else 2
    cards = min(n, count)
    b, t = x.shape[:2]
    torch.cuda.empty_cache()  # room for the ranks on card 0
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), x=x)
        print(graft_entry.launch(n, ["mesh", os.path.join(d, "in.npz"), d, "cuda", MESH_RUNS],
                                 timeout=MESH_TIMEOUT_S), end="", flush=True)
        files = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(n)]

    backend = "nccl" if count >= 2 else "gloo"
    want_counts = {k: t * v for k, v in {**PER_BLOCK, **DEC_PER_BLOCK}.items()}
    total = np.float32(0)
    for r, f in enumerate(files):
        if f["rows"].tolist() != [r * b // n, (r + 1) * b // n] or str(f["backend"]) != backend:
            raise AssertionError(f"rank {r}: rows {f['rows']}, backend {f['backend']}")
        if json.loads(str(f["launches"])) != want_counts:
            raise AssertionError(f"rank {r}: launch counts {f['launches']}, expected {want_counts}")
        for key in ("data", "size_bits", "complexity", "window_ctrl"):
            if not np.array_equal(f[key], f[f"alone_{key}"]):
                raise AssertionError(f"rank {r}: {key} differs from the no-mesh call on its rows")
        if not (str(f["refuse_split"]) and str(f["refuse_device"])):
            raise AssertionError(f"rank {r}: a refusal did not raise")
        if f["corrupt"].any() or not np.array_equal((f["bits"] + 7) // 8 * 8, f["size_bits"]):
            raise AssertionError(f"rank {r}: its blocks decode corrupt or to other sizes")
        total = np.float32(total + np.float32(int(f["size_bits"].sum())))
    if any(f["total_bits"] != total or f["total_bits"].dtype != np.float32 for f in files):
        raise AssertionError(f"all-reduced totals {[f['total_bits'] for f in files]}, "
                             f"float32 sum of the shards {total}")

    sizes = np.concatenate([f["size_bits"] for f in files])
    data = np.concatenate([f["data"] for f in files])
    check_encoded(torch.from_numpy(sizes), torch.from_numpy(data), b, t, cfg, "mesh")
    ref_sizes = encoded.size_bits.cpu().numpy()
    if not np.array_equal(np.concatenate([f["window_ctrl"] for f in files]),
                          encoded.window_ctrl.cpu().numpy()):
        raise AssertionError("mesh: window control differs from phase 4's")
    tot, tot_ref = int(sizes.sum()), int(ref_sizes.sum())
    worst = int(np.abs(sizes - ref_sizes).max())
    if abs(tot - tot_ref) > FLAT_SIZE_REL * tot_ref or worst > FLAT_BLOCK_BITS:
        raise AssertionError(f"mesh: total {tot} bits vs phase 4's {tot_ref}, a block {worst} "
                             f"bits apart")
    n_nz = torch.cat([analyze(x[r * b // n:(r + 1) * b // n], cfg, "cuda")[1] for r in range(n)])
    n_nz_differs = int((n_nz != analyze(x, cfg, "cuda")[1]).sum())
    if n_nz_differs > FLAT_N_NZ_SHARE * b * t:
        raise AssertionError(f"mesh: the coded count differs from phase 4's in {n_nz_differs} "
                             f"blocks")
    snr = decode_snr(x, np.concatenate([f["pcm"] for f in files]))
    if abs(snr - ref_snr) > FLAT_SNR_DB:
        raise AssertionError(f"mesh: round-trip SNR {snr:.2f} dB vs phase 7's {ref_snr:.2f} dB")
    same = int(np.all(data == encoded.data.cpu().numpy(), axis=-1).sum())
    same_size = int((sizes == ref_sizes).sum())
    print(f"mesh: each of {n} shards equals the no-mesh call on its rows; against phase 4 window "
          f"control identical, {same} of {b * t} blocks byte-identical, {same_size} of the same "
          f"size, total {tot} bits vs {tot_ref} ({(tot - tot_ref) / tot_ref:+.4%}), "
          f"largest difference of a block {worst} bits, coded count differs in {n_nz_differs} "
          f"blocks, round-trip SNR {snr:.2f} dB vs {ref_snr:.2f} dB; all-reduced total "
          f"{float(total):.1f} (float32)", flush=True)

    audio_s = b * t * cfg.block_size / cfg.rate_hz
    rtfs = {}
    for label, key, one in (("encode", "encode_s", enc_rtf), ("decode", "decode_s", dec_rtf)):
        walls = np.max([f[key] for f in files], axis=0)  # the slowest rank's, a run
        med = float(np.median(walls))
        rtfs[label] = audio_s / med
        print(f"mesh {label} realtime factor {audio_s / med:.1f}x over {n} ranks (median of "
              f"{len(walls)}: {audio_s:.1f} s of audio in {med:.3f} s, barrier to barrier; runs "
              f"{', '.join(f'{w:.3f}' for w in walls)} s), {audio_s / med / one:.2f}x phase "
              f"{4 if label == 'encode' else 7}'s {one:.1f}x [{card}]", flush=True)
    print(f"mesh over {n} ranks on {cards} card{'s' if cards > 1 else ''} ({backend}: "
          f"{', '.join(sorted({str(f['device']) for f in files}))})", flush=True)
    if cards == 1:
        print(f"mesh over {n} ranks on 1 card; multi-card NCCL not run", flush=True)
    return n, cards, json.loads(str(files[0]["launches"])), rtfs


def mesh_dryrun_and_entry(n, card):
    """Phase 17 (c): ``dryrun_multichip(n)`` and ``entry()``'s step once
    on the card."""
    import torch

    from ulcx_torch import graft_entry
    from ulcx_torch.codec.encoder import cbr_bit_budget
    from ulcx_torch.utils.config import CodecConfig

    graft_entry.dryrun_multichip(n)
    fn, args = graft_entry.entry()
    data, size, _ = fn(*args)
    torch.cuda.synchronize()
    budget = int(cbr_bit_budget(CodecConfig(rate_hz=44100, n_chan=2, block_size=ENTRY_BS),
                                RATE_KBPS))
    if data.device.type != "cuda" or not (0 < int(size.min()) and int(size.max()) <= budget):
        raise AssertionError(f"entry(): sizes {size.tolist()} on {data.device}")
    print(f"entry(): one CBR-128 block step of 8 stereo bs{ENTRY_BS} streams on {data.device}, "
          f"sizes {size.tolist()} (budget {budget}) [{card}]", flush=True)


def main() -> int:
    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card",
              file=sys.stderr)
        return 1
    sys.modules["jax"] = None  # the port must not need JAX,
    sys.modules["ulcx"] = None  # nor the JAX package
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from bench import make_corpus
    from ulcx_torch import _build
    from ulcx_torch.codec.encoder import cbr_bit_budget
    from ulcx_torch.utils.config import CodecConfig

    phase("2 build")
    path, secs = _build.build()
    _build.library()
    print(f"built {path.name} in {secs:.1f} s", flush=True)
    report = path.with_suffix(".ptxas.txt")
    if report.exists():  # absent when the library was already built
        spills = []
        for line in report.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("ptxas:", line.strip(), flush=True)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and m.groups() != ("0", "0"):
                spills.append(line.strip())
        print(f"ptxas spills: {spills or 'none'}", flush=True)
    refuse_other_geometry(_build.library())

    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=BS)
    if int(cbr_bit_budget(cfg, RATE_KBPS)) != CBR_BUDGET:
        raise AssertionError("CBR-128 bs2048 budget is not 5944 bits")
    x = make_corpus(MAIN_B, MAIN_T, BS)
    phase("3 kernels vs plain")
    print(f"B={MAIN_B}, P={2 * BS}:", flush=True)
    kres = kernels_vs_plain(cfg, x[:, :2].copy(), "cuda")
    cfg_r = CodecConfig(rate_hz=44100, n_chan=RAGGED_CHAN, block_size=RAGGED_BS)
    print(f"B={RAGGED_B}, P={RAGGED_CHAN * RAGGED_BS} (ragged):", flush=True)
    kernels_vs_plain(cfg_r, ragged_corpus(), "cuda", overflow_words=True)

    phase("4 main path")
    counts, warm, audio_s_enc, encoded = main_path(cfg, x, "cuda")
    enc_rtf = rtf_line("encode", warm, audio_s_enc, counts, card)

    phase("5 cuda vs cpu")
    cuda_vs_cpu(cfg, x[:CPU_B, :CPU_T].copy())

    streams, offs, win, sizes = pack_streams(encoded)
    phase("6 decode kernels vs plain")
    print(f"B={MAIN_B}, P={2 * BS}, window {win} bytes ({2 * win - 2} tokens):", flush=True)
    dres = decode_kernels_vs_plain(cfg, streams, offs, win, "cuda")
    print(f"B={RAGGED_B} (ragged), P={2 * BS}:", flush=True)
    decode_kernels_vs_plain(cfg, streams[:RAGGED_B], offs[:RAGGED_B], win, "cuda")
    fsm_vs_plain_synthetic(cfg, streams, win, "cuda")
    rng_vs_plain_synthetic(2 * BS, RAGGED_B, "cuda")

    phase("7 decode main path")
    dcounts, dwarm, audio_s, snr, decoded = decode_main_path(cfg, x, streams, win, sizes, "cuda")
    dec_rtf = rtf_line("decode", dwarm, audio_s, dcounts, card)

    phase("8 decode cuda vs cpu")
    decode_cuda_vs_cpu(cfg, streams, win)

    phase("9 transforms on the card")
    transforms_on_card("cuda", card)

    phase("10 large blocks")
    big, big_counts, big_dcounts = large_blocks("cuda", card)

    phase("11 folded encode")
    fold_counts = folded_encode(cfg, x, encoded, snr, "cuda", card)

    phase("12 single stream")
    one_counts = single_stream(cfg, "cuda", card)

    phase("13 past P = 32768")
    huge, huge_full, huge_counts, huge_dcounts = past_32768("cuda", card)

    phase("14 rate paths")
    rate_counts = rate_paths("cuda", card)

    phase("15 gap window")
    gap_counts = gap_window(cfg, x, "cuda", card, enc_rtf, int(encoded.size_bits.sum()))

    phase("16 tools")
    tool_counts = tools("cuda", card)

    phase("17 mesh")
    one_mesh_counts = mesh_of_one(cfg, x, encoded, decoded, streams, win, sizes, card)
    n_ranks, _, rank_counts, _ = mesh_ranks(cfg, x, encoded, snr, enc_rtf, dec_rtf, card)
    mesh_dryrun_and_entry(n_ranks, card)

    phase("18 scan path")
    scan_counts = scan_path("cuda", card)

    phase("19 public names")
    search_counts = public_names(cfg, x, "cuda", card)

    phase("20 inverse transform kernel")
    imdct_res = imdct_on_card("cuda", card)
    phase(None)

    rows = [(name, SOURCE, counts[name], v) for name, v in kres.items()]
    # the record-mode FSM's main path is the single-block decoder's
    rows += [(name, DEC_SOURCE, (scan_counts["decode_block"] if name == "fsm" else dcounts)[name], v)
             for name, v in dres.items()]
    kernels = []
    for name, source, launches, (err, ms, plain_ms, nbytes) in rows:
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"name": name, "route": "cuda", "source": source, "replaces": REPLACES[name],
               "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
        if name in REDESIGNED:
            row["bound_us"] = bound_ms * 1e3
            row["redesigned"] = REDESIGNED[name]
        if name in NOTES:
            row["note"] = NOTES[name]
        # beside the main path's: the same kernel at the bs4096 main path's
        # P = 8192, B = 256, and its launches on that and the folded paths
        row["ms_p8192_b256"], row["plain_ms_p8192_b256"] = big[name][1], big[name][2]
        row["launches_bs4096"] = {**big_counts, **big_dcounts}[name]
        # and at the bs32768 main path's P = 65,536: kernel and plain (on
        # the CPU, on HUGE_COLS of the streams) at its B = 256, and at the
        # ragged B = 13
        row["ms_p65536_b256"], row["max_abs_err_p65536_b256"] = huge_full[name][1], huge_full[name][0]
        row[f"plain_cpu_ms_p65536_b256_{len(HUGE_COLS)}_streams"] = huge_full[name][2]
        row["ms_p65536_b13"], row["plain_cpu_ms_p65536_b13"] = huge[name][1], huge[name][2]
        row["launches_bs32768"] = {**huge_counts, **huge_dcounts}[name]
        mesh_counts = {"mesh of one": {**one_mesh_counts[0], **one_mesh_counts[1]},
                       f"mesh rank 0 of {n_ranks}": rank_counts}
        for knob, c in {**fold_counts, **one_counts, **rate_counts, "gap": gap_counts,
                        **mesh_counts, **scan_counts, **tool_counts, **search_counts}.items():
            if name in c:
                row[f"launches {knob}"] = c[name]
        kernels.append(row)
    # the inverse transform's kernel, at the decode cell's shape and at P = 65,536
    err, ms, plain_ms, nbytes = imdct_res[IMDCT_MAIN]
    row = {"name": "imdct", "route": "cuda", "source": IMDCT_SOURCE,
           "replaces": "none: block_imdct_batched's class GEMMs, windowing and lap, plain "
                       "PyTorch in both packages",
           "launches": dcounts["imdct"], "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": None,
           "note": "max_abs_err is of each row's peak; times at " + IMDCT_MAIN}
    row.update({f"ms {label}": v[1] for label, v in imdct_res.items()})
    kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
