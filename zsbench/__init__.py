"""The benchmark of the PyTorch and CUDA port of ZeroShape (``zeroshape_tpu_torch``)."""
