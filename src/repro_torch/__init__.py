"""PyTorch/CUDA port of the FleetOpt serving system (the JAX package
``repro`` is the reference it is held against). Its subpackages mirror
``repro``'s layout; the decode kernels are hand-written CUDA for Hopper
(``kernels/csrc``). Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``."""
