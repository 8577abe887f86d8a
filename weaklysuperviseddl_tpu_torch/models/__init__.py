"""models of the PyTorch port (counterpart of weaklysuperviseddl_tpu.models)."""
