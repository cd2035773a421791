"""The model zoo (GCN_FC, GCN, GCNRand, GCNDeeper, GENDeeper) and the weights
carried across from JAX and reference checkpoints."""
