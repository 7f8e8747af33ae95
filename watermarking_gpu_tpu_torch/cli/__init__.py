"""The settings.ini command line (``python -m watermarking_gpu_tpu_torch``)."""
