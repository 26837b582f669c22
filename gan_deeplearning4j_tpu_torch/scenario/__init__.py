"""The combined train -> serve chaos scenario (torch twin of
``gan_deeplearning4j_tpu/scenario/``): ``runner.py``'s
:func:`run_scenario` stands up a fleet trainer, a serving mesh and the
checkpoint publisher, breaks both planes on a seeded chaos schedule and
returns a typed verdict; ``trainer_child.py`` is the fleet trainer as the
preemptible process it supervises (``python -m
gan_deeplearning4j_tpu_torch.scenario.trainer_child``)."""

from gan_deeplearning4j_tpu_torch.scenario.runner import run_scenario

__all__ = ["run_scenario"]
