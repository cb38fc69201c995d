"""The benchmark of henbun_tpu_torch on an NVIDIA H100: see README.md."""
