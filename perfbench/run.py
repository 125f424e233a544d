#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it is started on:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Needs as many CUDA cards as the cell asks
for; prints the result as the last line of standard output and the
compared numbers beside their limits as the last lines of standard
error. See perfbench/README.md.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
_CACHE = ROOT / "build" / "perfbench"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(_CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
