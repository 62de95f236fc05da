"""Runnable examples of the port (counterparts of the JAX package's
``examples/``), run as ``python -m repro_torch.examples.<name>``; each
takes ``--device cpu`` to run off the card."""
