"""Time the kernel rows of two checkouts on one card in one call, in turns
(other, this, this, other): each turn is a process that runs
``chip_smoke.phase_timings`` of its checkout (kernel, plain version,
library call, bound at the shapes the main path gives them) and prints
its rows as JSON; the table beside them is the ratio of this checkout's
median to the other's for every row both have.

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_parent.py build/parent

Needs a card; each checkout builds its own kernels (in parallel, before
the first turn).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DRIVE = ("import json, sys, torch, chip_smoke as cs\n"
         "rows = cs.phase_timings(torch.device('cuda', 0))\n"
         "print('ROWS ' + json.dumps({k: v['ms'] for k, v in rows.items()}), flush=True)\n")
BUILD = "import sys; sys.path.insert(0, 'src'); from repro_torch.kernels import _build; _build.build_all()"


def turn(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=tree, env=env, capture_output=True, text=True)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("ROWS ")]
    if out.returncode or not line:
        raise SystemExit(f"{tree}: rc {out.returncode}\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return json.loads(line[0][5:])


def main():
    other = Path(sys.argv[1]).resolve()
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=t) for t in (other, ROOT)]
    if any(b.wait() for b in builds):
        raise SystemExit("a build failed")
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        runs[who].append(turn(other if who == "other" else ROOT))
        print(f"turn {who} done", flush=True)
    common = sorted(set(runs["other"][0]) & set(runs["this"][0]))
    print(f"{'row':48s} {'other ms (2 turns)':>24s} {'this ms (2 turns)':>24s} ratio")
    for name in common:
        o = [r[name] for r in runs["other"]]
        t = [r[name] for r in runs["this"]]
        print(f"{name:48s} {o[0]:11.4f} {o[1]:11.4f} {t[0]:11.4f} {t[1]:11.4f} {sum(t) / sum(o):.3f}")
    print("ONLY THIS " + json.dumps(sorted(set(runs["this"][0]) - set(common))))


if __name__ == "__main__":
    main()
