"""The benchmark of xsmm_tpu_torch on the card (see ``run.py``)."""
