"""Run one cell of BENCHMARK.json on the card and print one JSON line:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up is timed from the first line here.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # the checkout's root and the port's sources, never this folder: its
    # module names (trace, tree, ...) would shadow others
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path[1:]
        if Path(p or ".").resolve() != ROOT / "perfbench"]
    # every kernel cache inside the checkout, at a fixed path
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)
    from perfbench.harness import main
    sys.exit(main(sys.argv[1:], T0, ROOT))
