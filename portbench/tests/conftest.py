"""The benchmark's tests: ``python -m pytest portbench/tests -q`` from the
root of the checkout (about five minutes on 8 CPU cores with ``-n 4``: the
tiny cells run the program's plain kernels).  Tests marked ``cuda`` need an
NVIDIA card and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the port's CUDA kernels); skips with a reason where "
        "torch.cuda.is_available() is false",
    )
