"""The benchmark of the PyTorch/CUDA port (``xvr_tpu_torch``) on one GPU."""
