"""How evenly the class-sharded step's pods share a step: over the traced
steps, the fastest pod's ``class_sharded.pod`` device seconds over the
slowest's (pods grouped by their ``trainer.step``)."""

from portbench.spans import balance, program_spans


def read(run):
    return balance(program_spans())
