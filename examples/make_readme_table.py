#!/usr/bin/env python
"""Regenerate the README robustness table from artifacts/ate_clone_*.json
(written by examples/eval_clone.py --out; the config/euroc.yaml:18-20
per-sequence quality table analog). Replaces the block after the
ROBUSTNESS_TABLE marker in README.md. The fps column names the card; a run
off the GPU reads "not measured"."""
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")

PROFILES = [
    ("euroc", "baseline circuit, 120 s, full texture"),
    ("loops", "2 laps, 6x IMU noise, weak-texture sectors (drift+closure)"),
    ("hard", "2x speed, 1.6x yaw, 25 ms blur, 0.55x contrast (V1_03 analog)"),
]


def row(profile, desc):
    p = os.path.join(ROOT, "artifacts", f"ate_clone_{profile}.json")
    if not os.path.exists(p):
        return None
    d = json.load(open(p))
    n = max(d.get("frames", 1), 1)
    lost_pct = 100.0 * d.get("n_lost", 0) / n
    if d.get("n_lost", 0) == 0:
        outcome = "good (tracked throughout)"
    elif d.get("tracking_finished_ok") and d.get("n_relocs", 0) > 0:
        outcome = (f"marginal (lost {lost_pct:.0f}% of frames, "
                   f"relocalized x{d['n_relocs']})")
    else:
        outcome = "fails (lost)"
    ate = d.get("ate_rmse_post_init", -1)
    dev = d.get("device", {})
    fps = (f"{d['e2e_fps_amortized']:.1f} ({dev['kind']})"
           if dev.get("platform") == "gpu" else "not measured")
    return (f"| {profile} | {desc} | {outcome} | "
            f"{1e3 * ate:.1f} mm | {d.get('loops_closed', 0)} | {fps} |")


def main():
    lines = [
        "| profile | conditions | outcome | ATE (post-init) | loops closed | fps (card) |",
        "|---|---|---|---|---|---|",
    ]
    for prof, desc in PROFILES:
        r = row(prof, desc)
        if r:
            lines.append(r)
    table = "\n".join(lines)
    readme = os.path.join(ROOT, "README.md")
    s = open(readme).read()
    marker = "<!-- ROBUSTNESS_TABLE -->"
    if marker not in s:
        print("marker missing in README.md", file=sys.stderr)
        sys.exit(1)
    head, rest = s.split(marker, 1)
    # drop any previous table (lines starting with |) directly after marker
    rest_lines = rest.splitlines()
    i = 0
    while i < len(rest_lines) and (not rest_lines[i].strip()
                                   or rest_lines[i].lstrip().startswith("|")):
        i += 1
    s2 = head + marker + "\n" + table + "\n" + "\n".join(rest_lines[i:])
    open(readme, "w").write(s2)
    print(table)


if __name__ == "__main__":
    main()
