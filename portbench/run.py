"""Run one cell of the benchmark of micronet_tpu_torch on this machine's cards:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the last lines of standard error are the numbers that
decided ``correct``, each beside its limit. Build and kernel caches stay
in fixed directories under ``build/`` of the checkout.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[0] = str(ROOT)

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
