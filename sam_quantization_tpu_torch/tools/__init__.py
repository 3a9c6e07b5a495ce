"""Tools of the port (counterparts of the repository's root ``tools/``: the
probes, the tile tuner, the quality table and its trainer), run as
``python -m sam_quantization_tpu_torch.tools.<name>``."""
