"""Reference-trajectory IO (PyTorch port of altro_tpu.io)."""
