"""Downstream urban-sound-classification datasets (port of
``l3embedding_tpu/data/usc``): feature computation, folds and the
per-dataset generators (US8K / ESC-50 / DCASE2013 SCD)."""
