"""data of the PyTorch port (counterpart of weaklysuperviseddl_tpu.data)."""
