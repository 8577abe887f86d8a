"""The benchmark of ``weaklysuperviseddl_tpu_torch`` on one NVIDIA H100
(``benchmark/run.py``); see ``benchmark/README.md``."""
