"""Example commands of the port, run as ``python -m ibu_tpu_torch.examples.<name>``."""
