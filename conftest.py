"""Repository-level pytest settings for the PyTorch port's tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA kernels); "
        "skips without one")
