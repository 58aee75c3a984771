"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints set-up's parts and the compared
numbers on standard error, and as its last line on standard output one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, and with --trace 1
a breakdown of the traced slice.  Exits non-zero, printing no result,
without as many CUDA cards as the cell asks for, or where the process
holds JAX or the JAX package when the window has closed."""
import time

T_IMPORT = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, is where imports start: a module
# here must not shadow a standard one
sys.path[0] = ROOT
# every build and kernel cache at a fixed path inside the checkout, so only
# a checkout's first run builds; nothing loads JAX behind the port's back
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, T_IMPORT))
