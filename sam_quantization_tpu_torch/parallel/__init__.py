"""Data, tensor and sequence parallelism and batched serving
(counterpart of ``sam_quantization_tpu/parallel``), on ``torch.distributed``."""
