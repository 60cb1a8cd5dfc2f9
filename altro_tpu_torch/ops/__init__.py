"""Kernels and batched iteration blocks (PyTorch port of altro_tpu.ops)."""
