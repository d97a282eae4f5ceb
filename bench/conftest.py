"""The benchmark's CPU tests run their tiny cells on one thread: the suite
runs in several worker processes at once, and tiny products gain nothing
from more."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
