#!/usr/bin/env python3
"""Paired realtime factors of two trees of the PyTorch port, on one card.

    python3 devtools/torch_rtf_pairs.py PARENT_DIR [PAIRS [RUNS]]   # from the repo root

Runs ``devtools/torch_rtf.py RUNS`` (7 warm runs by default) as one
process per tree, PAIRS times (10 by default), this tree and the tree
unpacked at PARENT_DIR (``git archive <commit> | tar -x -C PARENT_DIR``)
alternating which goes first. Each process's figure is the median of its
warm runs. Prints every pair, then for encode and decode: the pairs the
change won, both trees' medians over the processes, their ratio, and the
parent's quartiles (the spread a difference has to exceed); then one
JSON line with all of it. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_process(tree: str, runs: int) -> dict:
    """{"card", "encode_rtf", "decode_rtf"} of one torch_rtf.py process
    in ``tree``, each factor the median of its warm runs."""
    out = subprocess.run([sys.executable, "devtools/torch_rtf.py", str(runs)], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"torch_rtf.py failed in {tree}:\n{out.stdout}\n{out.stderr}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {"card": res["card"], "encode_rtf": statistics.median(res["encode_rtf"]),
            "decode_rtf": statistics.median(res["decode_rtf"])}


def main(parent: str, pairs: int, runs: int) -> int:
    trees = {"parent": os.path.abspath(parent), "change": HERE}
    rows = []
    for i in range(pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        row = {name: one_process(trees[name], runs) for name in order}
        rows.append(row)
        print(f"pair {i} ({order[0]} first) [{row['change']['card']}]: " + "; ".join(
            f"{m} parent {row['parent'][m + '_rtf']:.1f}x change {row['change'][m + '_rtf']:.1f}x"
            for m in ("encode", "decode")), flush=True)
    summary = {"card": rows[0]["change"]["card"], "pairs": pairs, "runs": runs}
    for m in ("encode", "decode"):
        par = [r["parent"][m + "_rtf"] for r in rows]
        chg = [r["change"][m + "_rtf"] for r in rows]
        q1, _, q3 = statistics.quantiles(par, n=4) if len(par) > 1 else (par[0],) * 3
        wins = sum(c > p for c, p in zip(chg, par))
        med_p, med_c = statistics.median(par), statistics.median(chg)
        summary[m] = {"parent": par, "change": chg, "change_wins": wins, "median_parent": med_p,
                      "median_change": med_c, "ratio": med_c / med_p, "parent_q1": q1,
                      "parent_q3": q3}
        print(f"{m}: change ahead in {wins} of {pairs} pairs; median parent {med_p:.1f}x, change "
              f"{med_c:.1f}x ({med_c / med_p:.3f}x); parent quartiles {q1:.1f}x-{q3:.1f}x",
              flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 10,
                  int(sys.argv[3]) if len(sys.argv) > 3 else 7))
