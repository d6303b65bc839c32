"""The benchmark's own tests: on the CPU at tiny sizes; those marked
``cuda`` run on a card (``python -m pytest -m cuda portbench/tests``) and
skip without one."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
