def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long interpret-mode kernel sweeps and wide engine matrices — "
        "excluded from the tier-1 run (pytest -m 'not slow'); the CI "
        "int8-interpret job runs the full suite including them")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the PyTorch port's hand-written "
        "CUDA kernels); skips with a reason elsewhere")
