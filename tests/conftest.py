def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the PyTorch port's kernel tests); skips "
        "where none is present")
