"""Training: losses, metrics and the single-device trainer
(``python -m lp_gnn_tpu_torch.train``)."""
