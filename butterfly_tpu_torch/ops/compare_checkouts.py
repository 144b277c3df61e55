"""Time the kernel phases of two checkouts on one card, in turns.

    python -m butterfly_tpu_torch.ops.compare_checkouts A_DIR B_DIR

Runs the kernel, flash and ring phases of each checkout's chip_smoke.py
(every kernel against its plain version, CUDA-event medians) in the order
A, B, B, A, each turn in a process of its own started in that checkout,
so both builds meet the same card, clocks and neighbours. Prints each
turn's phase lines, each checkout's ptxas report per kernel (registers,
spills, static shared memory), and one line per case with the four
kernel times. Both checkouts' phases are timed by one timer, this
checkout's chip_smoke._time_ms, so a change of the timer does not pass
for a change of the kernels. Times between two calls (two machines) are
not comparable; times inside one such run are. Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

_TURN = r"""
import importlib.util, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
spec = importlib.util.spec_from_file_location("timer_src", TIMER)
timer_src = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timer_src)
cs._time_ms = timer_src._time_ms
from butterfly_tpu_torch.ops import build
build.build_all()
print("PTXAS " + json.dumps({k: v[1] for k, v in build.build_log.items()}))
card = torch.cuda.get_device_name(0)
cs.phase_kernel(torch, card)
cs.phase_flash_kernel(torch, card)
cs.phase_ring(torch, card)
"""


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _turn(path: str):
    """One turn in `path`: its phase lines, its ptxas log (first turn
    only: later turns find the libraries built) and {case: kernel ms}."""
    timer = os.path.join(_ROOT, "chip_smoke.py")
    proc = subprocess.run([sys.executable, "-c",
                           f"TIMER = {timer!r}\n" + _TURN],
                          cwd=path, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {path} failed (rc {proc.returncode}):"
                           f"\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    out = proc.stdout
    ptxas, times, lines = {}, {}, []
    for line in out.splitlines():
        if line.startswith("PTXAS "):
            ptxas = json.loads(line[6:])
            continue
        lines.append(line)
        m = re.match(r"\[(kernel|flash|ring)\] case=(\S+) .*kernel_ms=(\S+)",
                     line)
        if m:
            times[f"{m.group(1)}/{m.group(2)}"] = float(m.group(3))
    return lines, ptxas, times


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import chip_smoke
    dirs = {"A": argv[0], "B": argv[1]}
    runs = []
    for side in "ABBA":
        lines, ptxas, times = _turn(dirs[side])
        for line in lines:
            print(f"[{side}] {line}", flush=True)
        for src, log in sorted(ptxas.items()):
            for kern, regs, spill, smem in chip_smoke._ptxas_kernels(log):
                print(f"[ptxas {side}] {src}: {kern}: {regs} registers, "
                      f"spill {spill}, static smem {smem} bytes",
                      flush=True)
        runs.append((side, times))
    cases = dict.fromkeys(c for _, times in runs for c in times)
    for case in cases:   # the cases of either checkout, A's first
        cells = " ".join(f"{side}={t.get(case, float('nan')):.4f}"
                         for side, t in runs)
        print(f"[compare] {case} {cells} (ms, turns in order)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
