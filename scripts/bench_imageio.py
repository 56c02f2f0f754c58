"""Time the port's image decoder (``ssp_torch.data.imageio.decode_gray``)
on the committed fixtures, one thread, by the host clock.

    python scripts/bench_imageio.py [--fixtures DIR]

Run from the root of a checkout: it imports that checkout's ``ssp_torch``,
so two trees compare by running the script from each root (copy it into an
older tree's ``scripts/``) on the same ``--fixtures`` directory, in one
call, alternating.  Per fixture: :func:`decode_ms`, or ``refused`` with the
decoder's message.  Prints the card's name and power limit where
``nvidia-smi`` runs, then one line per fixture, then one JSON object
``{"ms": {name: ms or null}}``.  ``chip_smoke.py`` phase 14 times its
decodes with :func:`decode_ms` too.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SECONDS, REPEAT = 0.3, 3  # per fixture: the best of REPEAT rounds of SECONDS of decodes


def decode_ms(decode, path) -> float:
    """ms per image of ``decode(path)``, one thread, by the host clock: one
    call to warm up, then the best of REPEAT rounds of SECONDS of calls."""
    decode(path)
    best = float("inf")
    for _ in range(REPEAT):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < SECONDS:
            decode(path)
            n += 1
        best = min(best, (time.perf_counter() - t0) / n * 1e3)
    return best


def main() -> None:
    root = Path.cwd()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--fixtures", type=Path, default=root / "tests" / "data" / "torch_imageio")
    args = parser.parse_args()
    sys.path.insert(0, str(root))
    from ssp_torch.data import imageio

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        smi = "no nvidia-smi"
    print(f"[bench_imageio] {root} | {smi}")
    out = {}
    for path in sorted(args.fixtures.iterdir()):
        if path.suffix not in (".jpg", ".png"):
            continue
        try:
            ms = decode_ms(imageio.decode_gray, path)
        except ValueError as err:
            out[path.name] = None
            print(f"{path.name}: refused ({str(err).split(': ', 1)[-1]})")
            continue
        out[path.name] = round(ms, 4)
        print(f"{path.name}: {ms:.4f} ms per image")
    print(json.dumps({"ms": out}))


if __name__ == "__main__":
    main()
