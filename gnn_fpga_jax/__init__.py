"""gnn_fpga_jax — a JAX message-passing GNN framework for HEP.TrkX-style
particle tracking (segment & hit classification), with the capabilities
of the reference repo `jmduarte/gnn-fpga` re-designed for JAX / XLA /
pjit.

Subpackages:
  core      graph pytrees (COO), static-shape batching/bucketing, NPZ I/O
  ops       gather / segment-sum, dense and blocked incidence primitives
  models    interaction-network MPNNs (segment/node classifiers), GCN family
  data      Toy2D generator, ACTS/TrackML + muon-endcap graph construction
  train     jitted training engine, metrics, NPZ checkpoint/resume
  compress  magnitude pruning / masked retraining (FPGA workflow)
  parallel  device meshes, data-parallel sharding, edge-partitioned graphs
  cli       command-line entry points (prepare-graphs, train, infer, plot)
"""

__version__ = "0.1.0"
