"""The JAX package's examples (``examples/``) on the port, each runnable as
``python -m lightkrylov_tpu_torch.examples.<name>``; on the card unless
``--cpu`` is given."""
