"""Run a cell on several seeds in one process and print what it compared.

    python3 -m benchmarks.control --workload <cell> --seeds 1,2,3 --seconds <s>
        [--trace 0|1] [--tf32 | --fault <name>]

Each seed is one run of ``benchmarks.run`` (its result line included),
in one process so that set-up is paid once for the build. With
``--tf32`` the GEMMs run in TF32: the control, the program in the
nearest precision below the float32 its configuration states, which the
comparison has to find not correct. With ``--fault`` the program runs
with one of ``FAULTS`` planted, which sets the upper reading of a number
that the control does not move. The benchmark's own runs never run
either. A line ``seed <n> <variant> correct=<c> <name>=<value> ...``
follows each run.
"""

from __future__ import annotations

import argparse
import sys


# Each fault gives the (module, name, replacement) patches that plant it.

def _seed_round_out():
    """The kernel plan's rate search without its seeded round: one
    classic round, then the final round over a bracket eight times
    wider."""
    from ulcx_torch.bitstream import fast_encode

    return [(fast_encode, "_seed_plan", lambda rounds: (min(1, rounds - 1), False))]


def _seeded_plan():
    """The seeded ladder where the route gives the exact one (P above
    32768, or a batch of no multiple of 8): the faster plan, which codes
    short of the budget."""
    from ulcx_torch.codec import encoder

    return [(encoder, "_use_kernel", lambda cfg, batch: True)]


def _no_transients():
    """Transient detection skipped: every block one long window (the
    detector's state still runs)."""
    import torch

    from ulcx_torch.analysis import batched

    real = batched.get_window_ctrl

    def long_windows(samples, st, cfg):
        wc, st = real(samples, st, cfg)
        return torch.full_like(wc, 0x10), st

    return [(batched, "get_window_ctrl", long_windows)]


FAULTS = {"seed_round_out": _seed_round_out, "seeded_plan": _seeded_plan,
          "no_transients": _no_transients}


def main(argv=None) -> int:
    from benchmarks import run

    p = argparse.ArgumentParser(prog="python3 -m benchmarks.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--tf32", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS))
    a = p.parse_args(argv)
    for mod, name, value in FAULTS[a.fault]() if a.fault else []:
        setattr(mod, name, value)
    variant = a.fault or ("tf32" if a.tf32 else "float32")
    rc = 0
    for seed in (int(s) for s in a.seeds.split(",")):
        out = {}
        code = run.main(["--workload", a.workload, "--seed", str(seed), "--seconds", str(a.seconds),
                         "--trace", str(a.trace)], tf32=a.tf32, out=out)
        rc = rc or code
        nums = " ".join(f"{k}={v['value']!r}" for k, v in out.get("compared", {}).items())
        print(f"seed {seed} {variant} correct={out.get('correct')} {nums}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
