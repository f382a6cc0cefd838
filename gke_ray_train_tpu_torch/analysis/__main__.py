"""``python -m gke_ray_train_tpu_torch.analysis kernelcheck`` — the port's
kernel verification entry point (counterpart of the ``kernelcheck`` verb
of ``python -m gke_ray_train_tpu.analysis``).

    kernelcheck [names...]      sweep every registered kernel (or those
                                named) against its oracle on the card
      --device cpu              sweep on the CPU instead (the plain
                                versions; the default is cuda, and
                                without a card the command fails)
      --record                  pin the observed errors as this device
                                type's pins instead of checking them
      --ledger-dir D            read / write the ledger in D
      --static-only             KER006 only, no sweep, no device

Exit code 0 when clean, 1 on any finding, 2 when the device is missing.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import List, Optional

import torch


def _device_name() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them, else the
    name torch gives."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gke_ray_train_tpu_torch.analysis")
    sub = parser.add_subparsers(dest="command", required=True)
    kc = sub.add_parser("kernelcheck", help="differential kernel check")
    kc.add_argument("names", nargs="*", help="kernels (default: all)")
    kc.add_argument("--record", action="store_true")
    kc.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    kc.add_argument("--ledger-dir", default=None)
    kc.add_argument("--static-only", action="store_true")
    args = parser.parse_args(argv)

    from gke_ray_train_tpu_torch.analysis.kernelcheck import main_check
    name = None
    if not args.static_only and args.device == "cuda":
        if not torch.cuda.is_available():
            print("kernelcheck: no CUDA device; pass --device cpu to sweep "
                  "the plain versions on the CPU", file=sys.stderr)
            return 2
        name = _device_name()
        print(f"device: {name}")
    return main_check(args.names or None, device=args.device,
                      static_only=args.static_only, record=args.record,
                      ledger_dir=args.ledger_dir, device_name=name)


if __name__ == "__main__":
    sys.exit(main())
