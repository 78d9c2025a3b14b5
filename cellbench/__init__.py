"""The benchmark of the PyTorch/CUDA renderer (see run.py)."""
