"""optimizer_wait_ms.train: idle device ms a step in the gaps opened
under the program's ``train.optimizer`` span (train/step.py:
``apply_gradients``, the gradient norm and AdamW's update), over every
step of the traced window (portbench/spans.py)."""


def read(record):
    from portbench.spans import span_column

    return span_column(record, "train.optimizer", "idle_ms", "steps")
