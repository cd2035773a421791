"""lp-gnn-tpu on PyTorch and CUDA: data prep, training, basis prediction,
warm starts and reporting on an NVIDIA H100.

A second implementation of ``lp_gnn_tpu`` (the JAX package, which stays the
reference). It keeps the JAX package's layout and module names, so every
module here has a counterpart of the same path there (``prep.py`` holds the
data-prep half of ``lp_gnn_tpu/pipeline.py``, apart so that its solver
processes import no torch), and it imports neither JAX nor anything of
``lp_gnn_tpu``: what it needs from JAX-free modules there (the msgpack blob
codec, MPS and ``.bas`` files, the generators, the HiGHS bridge, the
reporting, the decode) it keeps as its own copy. No module needs pandas.

The flagship pipeline runs end to end: ``run_prep_data`` (generate an LP
family, cold-solve it with HiGHS, label, write the blobs) and
``run_train_test`` (train GCN_FC over a hand-written CUDA SpMM whose
backward is the same kernel over the transpose edge ordering, predict
bases, calibrate the warm gate, warm-start the solver, score, report into
``time.json``). The serving path, ``pred_basis``, goes processed LP blob ->
graph tensors (CSR and CSC edge orderings) -> GCN_FC forward -> top-m
decode -> HiGHS ``.bas`` + ``.sort``, with the per-LP pure-inference time;
under ``--mesh_shape edge=K`` the same forward is edge-partitioned into K
shards with the boundary halo exchange (a hand-written CUDA all-to-all),
all shards on one device. Graphs above ``--edge_num_thresh`` without a
mesh are served by exact sampled shards and trained on fanout-sampled
subgraphs; ``--graph_batch`` and ``--mesh_shape dp=K`` (K processes over
``torch.distributed``) train several graphs a step, and ``--mesh_shape
dp=K,edge=E`` a rank's block of a batch of edge-partitioned graphs.
``engine_table``, ``decode_sweep``, ``degeneracy_probe`` and
``bench_partition`` are the twins of the JAX package's analysis scripts.
ROADMAP.md lists what is still to come.

Subpackages
-----------
- ``utils``   msgpack+numpy blob codec (plain Python), json, the results
              table, the run dir's logs, path helpers
- ``data``    LP generators, scaling and features, raw -> processed blobs,
              the dataset, graph tensors on a device and their disjoint
              union, the neighbor sampler, the stack key
- ``ops``     CSR SpMM and row gather: CUDA kernels, their plain versions;
              the host SpMM over the native engine's library
- ``parallel`` edge mesh, graph partition, halo all-to-all kernel, the
              dist step; the dp process group and the batched step; dp x
              edge
- ``models``  GCN_FC as an ``nn.Module``; weights carried from JAX / torch
- ``infer``   top-m decode, prediction, validation and timing passes
- ``train``   losses, metrics, the trainer and its entry point
- ``io``      MPS and ``.bas`` files
- ``solver``  HiGHS through scipy's bindings, the native C++ simplex
              (g++ at first use), the crash basis
- ``reporting`` solver-log parsing, the results table and its summary

Entry points run on ``cuda`` and raise when no GPU is found, unless the
caller asks for the CPU (``device="cpu"``, CLI ``--device cpu``).
"""

__version__ = "0.1.0"
