"""Mean host ms of a ``Predictor.predict_compact`` call's ingest (the
port's ``predict.ingest`` span: the input pinned and its copy enqueued),
from the port's own spans."""

from snetbench import program


def read(r):
    return program.mean_host_ms(program.spans(), "predict.ingest")
