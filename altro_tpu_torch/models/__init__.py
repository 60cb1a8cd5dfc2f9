"""Dynamics models (PyTorch port of altro_tpu.models; the bicycle and midpoint slice)."""
