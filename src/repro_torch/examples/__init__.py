"""Runnable examples of the port, twins of the JAX package's ``examples/``:

  python -m repro_torch.examples.quickstart [--device cpu]
  python -m repro_torch.examples.truth_finding_e2e [--sources N] [--items N]
  python -m repro_torch.examples.fusion_weighted_training [--steps N]

Each runs on the card unless given ``--device cpu``.
"""
