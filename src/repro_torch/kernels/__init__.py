"""Hopper kernels of the port: each ``<name>/`` holds ``ref.py`` (plain torch), ``cuda.py`` (build + ctypes binding of ``csrc/``) and ``ops.py`` (dispatch)."""
