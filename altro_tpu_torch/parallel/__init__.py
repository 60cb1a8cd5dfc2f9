"""Batched helpers (PyTorch port of altro_tpu.parallel; batch_init_state only)."""
