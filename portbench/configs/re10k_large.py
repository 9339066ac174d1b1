"""re10k_large: trained. The program's side is the port's training step
(``train/step.make_train_step``, as ``main.train`` builds it), the plain
reference's side the frozen copy in float32 with TF32 off
(``portbench.sides``)."""

from portbench.sides import train_program, train_reference

__all__ = ["train_program", "train_reference"]
