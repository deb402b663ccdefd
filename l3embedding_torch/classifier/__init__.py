"""Downstream classification (port of ``l3embedding_tpu/classifier``): the
MLP in torch on the card, sklearn SVM/RF on the host, hyperparameter
search, file-level evaluation and metrics."""
