"""Runnable examples of the port, the twins of the repository's
``examples/`` (``python -m henbun_tpu_torch.examples.<name>``)."""
