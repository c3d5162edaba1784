"""Examples of the port, the counterparts of the root ``examples/`` scripts
(one module each, run as ``python -m repro_torch.examples.<name>``):

  quickstart   — train a smoke model a few steps, then greedy-decode
  serve_batch  — mixed-length requests through the ragged engine
  serve_stream — streaming handles and cancel-on-timeout
  sweep_demo   — the paper's Nproc sweep in miniature, both engines
  train_100m   — a ~100M-parameter training run with checkpoints

Each runs on the card unless given ``--device cpu``.
"""
