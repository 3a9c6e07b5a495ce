"""Click-loop and NoC evaluation of the port (counterpart of
``sam_quantization_tpu/evaluation``)."""
