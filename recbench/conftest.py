def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and nvcc (the port's kernels "
        "have no CPU mode); skips where there is none")
