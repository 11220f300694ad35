"""The reference's examples on the port: ``python -m
repro_torch.examples.<name> [--device cuda|cpu]``, each with a ``main`` that
returns the facts it prints."""
