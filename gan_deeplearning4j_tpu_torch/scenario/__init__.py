"""The train -> serve scenario's parts (torch twin of
``gan_deeplearning4j_tpu/scenario/``): ``trainer_child.py``, the fleet
trainer as the preemptible process a scheduler sees (``python -m
gan_deeplearning4j_tpu_torch.scenario.trainer_child``).  The scenario
runner that supervises it (the JAX ``scenario/runner.py``: the combined
chaos schedule over both planes) is not ported yet (ROADMAP Queue 1 item
10.4)."""
