"""PyTorch/CUDA port of the FB+-tree package ``repro`` (same subpackage and
module names). Imports torch and numpy, never JAX or ``repro``; entry points
build on the CUDA card unless asked for the CPU (``target="cpu"``)."""
