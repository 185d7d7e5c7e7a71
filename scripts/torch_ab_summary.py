#!/usr/bin/env python3
"""Summarise A/B logs of ``scripts/torch_ab_kernels.py`` (no card needed):

    python3 scripts/torch_ab_summary.py AB_LOG [AB_LOG ...]

Each log holds the script's last JSON line, ``{"runs": [...]}``: one run a
ROOT, in the order given (A, B, B, A), each the timings of one checkout.
For every timing (``ms``/``*_ms`` leaves, and the plain numbers under
``K18`` and ``library``) this prints the mean of A's runs, the mean of B's,
B's difference from A in percent, and each side's own spread (the distance
between its two runs over their mean), marking with ``!`` a difference
past 3% that is larger than both spreads.  The timings' names follow
``torch_ab_kernels.py``: a kernel at a workload, and ``attn``, ``ffn``,
``row``, ``products``, ``mma`` for its parts.
"""

from __future__ import annotations

import json
import sys


def leaves(d: dict, prefix: str = "") -> dict:
    """Numeric timings of one run, by their path."""
    out = {}
    for k, v in d.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(leaves(v, path + " "))
        elif isinstance(v, (int, float)) and not isinstance(v, bool) and (
                k == "ms" or k.endswith("_ms") or prefix.startswith(
                    ("K18 ", "library "))):
            out[path] = float(v)
    return out


def last_runs(path: str) -> list:
    runs = None
    with open(path) as f:
        for line in f:
            if line.startswith('{"runs"'):
                runs = json.loads(line)["runs"]
    if runs is None:
        raise SystemExit(f"{path}: no runs line")
    return [r for r in runs if "root" in r]


def summarise(path: str) -> None:
    runs = last_runs(path)
    roots = list(dict.fromkeys(r["root"] for r in runs))
    if len(roots) != 2:
        raise SystemExit(f"{path}: {len(roots)} checkouts, expected 2")
    by_root = {root: [leaves({k: v for k, v in r.items() if k != "root"})
                      for r in runs if r["root"] == root] for root in roots}
    a, b = (by_root[r] for r in roots)
    print(f"## {path}: A {roots[0]}, B {roots[1]}")
    worst = 0.0
    for name in a[0]:
        av = [x[name] for x in a if name in x]
        bv = [x[name] for x in b if name in x]
        if not av or not bv or min(av + bv) <= 0.0:
            continue
        am, bm = sum(av) / len(av), sum(bv) / len(bv)
        diff = 100.0 * (bm - am) / am
        spread = [100.0 * (max(v) - min(v)) / (sum(v) / len(v))
                  for v in (av, bv)]
        flag = "!" if abs(diff) > 3.0 and abs(diff) > max(spread) else " "
        worst = max(worst, abs(diff)) if flag == "!" else worst
        print(f"{flag} {name:48s} A {am:9.5f}  B {bm:9.5f}  {diff:+6.2f}%"
              f"  spread A {spread[0]:5.2f}% B {spread[1]:5.2f}%")
    print(f"# largest flagged difference: {worst:.2f}%")


if __name__ == "__main__":
    for p in sys.argv[1:]:
        summarise(p)
