"""Repository-level pytest settings for the PyTorch port's tests."""
import importlib.util
import os
import shutil

_NATIVE_INIT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "horovod_tpu", "native", "__init__.py")


def _build_native_once():
    """Build the reference's native library before any test process
    imports it. Its ``build()`` compiles to one fixed ``<so>.tmp`` path,
    so workers that each find the library missing race on that name: the
    loser's test fails and its ``native.available()`` caches the failure
    for every later test in the process. Built here once, every worker
    finds the finished library. The module is stdlib only; it is loaded
    from its file under a private name, so nothing imports the package
    (which would import jax). No compiler, or a failed build, leaves
    things as they were."""
    if shutil.which("g++") is None or not os.path.exists(_NATIVE_INIT):
        return
    try:
        spec = importlib.util.spec_from_file_location("_hvd_native_build",
                                                      _NATIVE_INIT)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.build()
    except Exception:  # noqa: BLE001 — the tests report their own skips
        pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA kernels); "
        "skips without one")
    # the controller (or a run without xdist) only: workers have
    # ``workerinput`` and start after the controller's configure
    if not hasattr(config, "workerinput"):
        _build_native_once()
