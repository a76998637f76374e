"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the ``tfidf_tpu_torch`` package. The caches the run fills (Python
bytecode, the port's kernel libraries, Triton's) are fixed directories
under ``build/benchmark/`` in the checkout, so only a checkout's first run
builds. The last line of standard output is the result as one JSON
object; the numbers that decided ``correct`` are also the last lines of
standard error.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
_CACHE = os.path.join(_ROOT, "build", "benchmark")

# before anything heavy is imported: one bytecode cache, and the program's
# kernel caches at fixed paths inside the checkout
sys.pycache_prefix = os.path.join(_CACHE, "pycache")
sys.dont_write_bytecode = False
os.environ["TFIDF_TORCH_BUILD_DIR"] = os.path.join(_CACHE, "kernels")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
sys.path[:0] = [_HERE, _ROOT]

from harness.cell import run  # noqa: E402

if __name__ == "__main__":
    rc = run()
    sys.stdout.flush()
    sys.stderr.flush()
    # end here: the program's worker threads (coalescer, search pipeline,
    # merge pool) are idle, and tearing down CUDA under them can abort
    os._exit(rc)
