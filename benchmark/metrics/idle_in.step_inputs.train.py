"""The device's idle share of the traced window while the train step
prepared its inputs (``usip.step.inputs``: draws, siamese copies,
node sampling, augmentation)."""
from benchmark.metrics._spans import idle_in


def read(w):
    return idle_in(w, ("usip.step.inputs",))
