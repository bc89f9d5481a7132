

def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips "
                   "without one")
