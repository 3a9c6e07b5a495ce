"""Measurement drivers of the port (counterparts of the JAX package's
``tools/`` probes), run as ``python -m sam_quantization_tpu_torch.tools.<name>``."""
