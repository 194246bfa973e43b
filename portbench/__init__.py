"""The benchmark of the PyTorch and CUDA port (`ertdx_torch`); run a cell
with `python3 portbench/run.py` (see run.py)."""
