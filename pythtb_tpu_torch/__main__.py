"""Diagnostics entry point: ``python -m pythtb_tpu_torch [--cpu]``.

Prints the versions, the device (on the card: its name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them), the dtype policy, and runs a one-line self-check: the Chern
number of the Haldane model on a 31 x 31 grid.  It runs on the CUDA card,
or on the CPU when ``--cpu`` is given; without a card and without
``--cpu`` it fails (no fallback).  Exit code 0 when the check passes.
"""

import argparse
import subprocess
import sys
import time


def _card_line(dev):
    """nvidia-smi's name and power limit of the card ``dev``."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return "nvidia-smi failed: %s" % exc
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or dev.index >= len(lines):
        return "nvidia-smi failed (rc %d)" % smi.returncode
    return lines[dev.index]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m pythtb_tpu_torch", description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the CUDA card")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    import pythtb_tpu_torch as ptt
    from pythtb_tpu_torch import config, flows, models

    print("pythtb_tpu_torch %s (PythTB-compatible API %s)" % (ptt.__version__, ptt.PYTHTB_COMPAT_VERSION))
    print("torch %s | CUDA %s | python %s" % (torch.__version__, torch.version.cuda, sys.version.split()[0]))
    dev = config.set_device("cpu") if args.cpu else config.checked_device()
    if dev.type == "cuda":
        print("device: %s (%s) | nvidia-smi name, power.limit: %s"
              % (dev, torch.cuda.get_device_name(dev), _card_line(dev)))
    else:
        print("device: cpu (the kernels' plain PyTorch versions)")
    print("dtypes: %s / %s on every device | TF32 matmul %s, cuDNN %s"
          % (config.FLOAT, config.COMPLEX, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))

    t0 = time.perf_counter()
    c = flows.chern_number(models.haldane(), [0], nk=(31, 31))
    dt = time.perf_counter() - t0
    ok = bool(np.isfinite(c)) and abs(abs(c) - 1.0) < 1e-3
    print("self-check: Haldane Chern = %.6f (31 x 31) in %.2fs -> %s" % (c, dt, "OK" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
