"""lp-gnn-tpu on PyTorch and CUDA: training and basis prediction on an NVIDIA
H100.

A second implementation of ``lp_gnn_tpu`` (the JAX package, which stays the
reference). It keeps the JAX package's layout and module names, so every
module here has a counterpart of the same path there, and it imports neither
JAX nor anything of ``lp_gnn_tpu``: what it needs from JAX-free modules
there (the msgpack blob codec, ``.bas`` files, the decode) it keeps as its
own copy.

What runs here so far is training, ``python -m lp_gnn_tpu_torch.train``
(one device, full graphs: GCN_FC forward and backward over a hand-written
CUDA SpMM whose backward is the same kernel over the transpose edge
ordering, the four losses, Adam + StepLR, checkpoints), and the serving
path, ``pred_basis``: a processed LP blob -> graph tensors (CSR and CSC
edge orderings) -> GCN_FC forward -> top-m decode -> HiGHS ``.bas`` +
``.sort``, with the per-LP pure-inference time; and, under ``--mesh_shape
edge=K``, the same forward edge-partitioned into K shards with the
boundary halo exchange (a hand-written CUDA all-to-all), all shards on one
device. ROADMAP.md lists what is still to come.

Subpackages
-----------
- ``utils``   msgpack+numpy blob codec (plain Python), json, path helpers
- ``data``    processed-blob dataset, graph tensors on a device
- ``ops``     CSR SpMM and row gather: CUDA kernels, their plain versions
- ``parallel`` edge mesh, graph partition, halo all-to-all kernel, dist GCN_FC
- ``models``  GCN_FC as an ``nn.Module``; weights carried from JAX / torch
- ``infer``   top-m decode, prediction and timing passes
- ``train``   losses, metrics, the trainer and its entry point
- ``io``      HiGHS ``.bas`` files

Entry points run on ``cuda`` and raise when no GPU is found, unless the
caller asks for the CPU (``device="cpu"``, CLI ``--device cpu``).
"""

__version__ = "0.1.0"
