"""Data sources of the port (counterpart of ``sam_quantization_tpu/data``)."""
