"""AdamW's share of a training step on the device: the ``trainer.optimizer``
spans' device seconds (the global norm, the clip, every leaf's update)
over the ``trainer.step`` spans' of the traced steps."""

from portbench.spans import program_spans, ratio


def read(run):
    return ratio(program_spans(), ("trainer.optimizer", "device_s"),
                 ("trainer.step", "device_s"))
