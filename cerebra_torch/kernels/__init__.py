"""Build and load the hand-written CUDA kernels (see `_build.py`)."""
