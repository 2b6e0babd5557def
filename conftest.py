"""Repository-wide pytest setup: build the JAX package's native code once,
before any test worker starts.

The JAX package's loaders build into the shared native/build/ with a
non-atomic `g++ -o` and, when loading fails, return None for the rest of
the process. Seven tests (tests/test_topo_native.py,
tests/test_pairs_native.py) decide in a skipif at collection whether their
library loads, and every xdist worker runs that skipif: a worker that met a
file another worker was still writing skipped them. Built here, in the
controller (or the only process, without xdist), each library is newer
than its source by the time a worker looks, and a worker's loader only
loads it.

On a machine without jax or PyYAML (the GPU machine, which runs the CUDA
tests) the imports fail, and nothing is built.
"""

import importlib

JAX_NATIVE_LOADERS = (
    ("sam_road_tpu.graph.nms", "_load_native"),
    ("sam_road_tpu.inference.pairs", "_load_native"),
    ("sam_road_tpu.metrics._native", "load_topo_native"),
    ("sam_road_tpu.metrics.apls_native", "ensure_apls_binary"),
)


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built them
        return
    for name, loader in JAX_NATIVE_LOADERS:
        try:
            module = importlib.import_module(name)
        except ImportError:
            continue
        getattr(module, loader)()
