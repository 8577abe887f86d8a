"""ops of the PyTorch port (counterpart of weaklysuperviseddl_tpu.ops)."""
