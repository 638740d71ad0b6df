"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
harness, its configurations and traffic mixes, its metric readers, the
yardstick (peaks, trace reading, the comparison) and the plain
reference.  It imports nothing of the program at import time."""
