"""The plain reference: plain PyTorch and NumPy, importing nothing of the
program under test (`model.py`: the CondUNet; `sampler.py`: scaling,
DDIM, inverse and statistics)."""
