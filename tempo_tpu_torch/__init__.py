"""tempo_tpu_torch — the PyTorch/CUDA port of tempo_tpu for NVIDIA Hopper.

The package mirrors tempo_tpu/ path for path and imports nothing of it
(nor of jax). This slice covers the compaction+sketch step
(parallel/compaction.local_compaction_step, exposed by entry.entry) and
TraceQL metrics query_range over span batches (metrics_engine), whose
reduction runs the hand-written CUDA kernel ops/pallas_kernels.seg_bincount.
"""
