"""masks of the PyTorch port (counterpart of weaklysuperviseddl_tpu.masks)."""
