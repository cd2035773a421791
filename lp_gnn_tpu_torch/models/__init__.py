"""GCN_FC and the weights carried across from JAX and reference checkpoints."""
