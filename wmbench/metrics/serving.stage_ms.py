"""Mean ms of a batch's ``serving.stage`` span: the dispatcher's
``np.stack`` of the frames, the copy to the card and the launches
(program spans of ``serving.py``)."""

from wmbench.spans import duration_ns, program_spans


def read(ctx):
    spans = program_spans("serving.stage")
    if spans is None:
        return None
    stages = [span for span in spans if span.name == "serving.stage"]
    return duration_ns(stages) / 1e6 / len(stages)
