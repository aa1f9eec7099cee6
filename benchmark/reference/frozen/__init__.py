"""A frozen copy of the port's plain PyTorch twins, the reference's
arithmetic.

Each module is ``supereight_tpu_torch``'s module of the same path, as it
stood when the benchmark was defined, with the package's imports pointed
here and every CUDA wrapper taken out (with the private helpers only
they used): what is left is the twins (``*_plain``) and the plain torch
they share. Nothing here imports the port, so a later change to the
port's kernels or twins leaves the yardstick as it is.
"""
