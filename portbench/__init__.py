"""The benchmark of the PyTorch and CUDA port (``vtpu_torch``): one command
runs one cell (``portbench/run.py``); see ``portbench/README.md``."""
