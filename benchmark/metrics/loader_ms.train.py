"""Mean host time the engine waited for each batch of the train loader
(the benchmark's wrapper around the loader it hands the engine)."""
from benchmark.metrics._shared import mean_ms


def read(w):
    return mean_ms(w.spans_s.get("benchmark.loader", []))
