"""Click-loop fine-tuning (counterpart of ``sam_quantization_tpu/train``)."""
