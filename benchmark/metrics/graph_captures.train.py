"""CUDA graphs captured inside the traced round, from the program's
``graph/capture`` spans: 0 where every chunk and sweep batch replays a graph
captured at set-up."""

from benchmark import program_spans


def read(run):
    spans = program_spans.spans(run)
    return None if spans is None else sum(sp.name == "graph/capture" for sp in spans)
