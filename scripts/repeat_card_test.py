"""Run one pytest node many times in one process and count its outcomes:
a check for a test that failed once and passed on its reruns.

    python scripts/repeat_card_test.py NODEID [--times 20] [--root DIR]

NODEID is relative to the checkout at `--root` (default: the one holding
this script), whose `src/` and `tests/` are imported, so that another
checkout (a parent commit unpacked beside this one) runs its own code.
Each run prints pytest's summary; the last line is a JSON object with the
node, the checkout, the count of runs and of each exit code, and the
seconds taken.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nodeid")
    ap.add_argument("--times", type=int, default=20)
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path[:0] = [str(root / "src"), str(root / "tests")]
    os.chdir(root)
    import pytest
    codes = Counter()
    t0 = time.perf_counter()
    for i in range(args.times):
        rc = int(pytest.main(["-q", "-p", "no:cacheprovider", "-p",
                              "no:randomly", args.nodeid]))
        codes[rc] += 1
        print(f"[repeat] run {i + 1} of {args.times}: exit {rc}", flush=True)
    print(json.dumps({"node": args.nodeid, "root": str(root),
                      "runs": args.times,
                      "exit_codes": {str(k): v for k, v in codes.items()},
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if set(codes) == {0} else 1


if __name__ == "__main__":
    sys.exit(main())
