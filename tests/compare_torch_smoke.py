"""Runs ``chip_smoke.py`` of one or more checkouts of the repo one after
another on the same card and host, so that two versions' smoke times are
compared on one machine.

    python3 tests/compare_torch_smoke.py [--out DIR] ROOT [ROOT ...]

Each run's output goes to ``DIR/smoke_<i>.log`` (default ``logs/compare_smoke``),
each line stamped with the seconds since that run began. For each run one
JSON line is printed: the root, the exit code, the seconds of the whole
command, each phase line's seconds since the one before it (in order,
``[phase, seconds]``), and the run's last line.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def run(root, log_path):
    t0 = time.perf_counter()
    phases, last, previous = [], "", 0.0
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.join(root, "chip_smoke.py")], cwd=root,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, bufsize=1)
        for line in proc.stdout:
            now = time.perf_counter() - t0
            log.write(f"{now:.3f} {line}")
            last = line.strip() or last
            if line.startswith('{"phase": '):
                try:
                    phase = json.loads(line)["phase"]
                except ValueError:
                    continue
                phases.append([phase, now - previous])
                previous = now
        rc = proc.wait()
    return {"root": root, "rc": rc, "seconds": time.perf_counter() - t0, "phase_s": phases, "last_line": last}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="+", help="checkouts of the repo, run in this order")
    parser.add_argument("--out", default=os.path.join("logs", "compare_smoke"))
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    for i, root in enumerate(args.roots):
        print(json.dumps(run(os.path.abspath(root), os.path.join(args.out, f"smoke_{i}.log"))), flush=True)


if __name__ == "__main__":
    main()
