"""The benchmark's tests: plain CPU tests of its contract, arithmetic and
checks, and card tests (marked `cuda`) that skip inside a fixture where
there is no card. They import neither JAX nor the JAX package.

    python -m pytest portbench/tests -q            # the CPU tests
    python -m pytest portbench/tests -q -m cuda    # on the card
"""
import pytest
import torch


def pytest_configure(config):
  config.addinivalue_line(
      'markers', 'cuda: needs an NVIDIA GPU; skips inside a fixture where '
      'there is none')


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('no CUDA device: the benchmark measures the card')
  return torch.device('cuda:0')


@pytest.fixture(autouse=True)
def _one_thread():
  torch.set_num_threads(1)
