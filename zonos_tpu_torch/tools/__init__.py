"""The repository's commands on the port: ``python -m zonos_tpu_torch.tools.<name>``."""
